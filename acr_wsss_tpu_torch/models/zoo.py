"""Pretrained weights: the zoo npz, its fetch from a local file, and the
trunk's graft: the part of ``acr_wsss_tpu/models/zoo.py`` the port's
names need.

``ZOO_URLS`` holds JAX's upstream checkpoint URL (``:36``) of every name
of the port's registry that has one. ``fetch`` (``:586``) converts a
checkpoint into the zoo npz ``<ACR_WSSS_ZOO>/<name>_in21k.npz`` through
``convert_state_dict`` (``:648``: the Swin, PiT, ViT/DeiT, BiT and CNN
mappers of ``models/convert.py``, in JAX's order; JAX's routing has no
rule for the two pruned ECA-ResNets, so neither has the port's), in JAX's
cache layout: the upstream file sits
beside it under its own basename. The port downloads nothing: ``fetch``
reads a ``file://`` URL, or the upstream file already in the zoo
directory, so a directory that mirrors the upstream files serves
``create_model(..., pretrained=True)``. JAX's checks of a fetched file
come along (``_validate_checkpoint_file`` ``:880``: a size floor, the
sha256 prefix of timm's file names). The ``hf_hub:`` source is not ported.

``init_with_pretrained`` (``:908-940``) puts a zoo npz's ``params/trunk/``
entries onto an ACR model; the classifier head keeps its seeded init, as
the reference's classifier-filtered ``load_pretrained`` leaves it.

``graft_standalone`` (``:943-980``) puts a zoo npz onto a model of the
registry, whose npz holds the whole model: timm's classifier filtering,
and PiT's position embedding resized to the model's grid
(``resize_bilinear_antialiased``, JAX's ``jax.image.resize(...,
"bilinear")``).
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from acr_wsss_tpu_torch.models.acr import init_random_
from acr_wsss_tpu_torch.models.convert import (attn_resnet_state_dict_to_flax,
                                               bit_npz_to_torch_names,
                                               densenet_state_dict_to_flax,
                                               efficientnet_state_dict_to_flax,
                                               flax_to_state_dict,
                                               legacy_senet_state_dict_to_flax,
                                               mobilenetv3_state_dict_to_flax,
                                               pit_state_dict_to_flax,
                                               regnet_state_dict_to_flax,
                                               resnet_state_dict_to_flax,
                                               resnetv2_bit_state_dict_to_flax,
                                               scanned_to_unrolled, sknet_state_dict_to_flax,
                                               state_dict_to_flax, swin_state_dict_to_flax,
                                               timm_resnet_state_dict_to_flax,
                                               vgg_state_dict_to_flax,
                                               vit_timm_state_dict_to_flax)
from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz, save_params_npz

TRUNK = "params/trunk/"

ZOO_URLS: Dict[str, str] = {
    "pit_b":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_b_820.pth",
    "pit_b_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_b_820.pth",
    "pit_b_distilled_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_b_distill_840.pth",
    "pit_s":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_s_809.pth",
    "pit_s_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_s_809.pth",
    "pit_s_distilled_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_s_distill_819.pth",
    "pit_ti_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_ti_730.pth",
    "pit_ti_distilled_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_ti_distill_746.pth",
    "pit_xs_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_xs_781.pth",
    "pit_xs_distilled_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-pit-weights/pit_xs_distill_791.pth",
    "resnetv2_50x1_bitm":
        "https://storage.googleapis.com/bit_models/BiT-M-R50x1-ILSVRC2012.npz",
    "resnetv2_50x1_bitm_in21k":
        "https://storage.googleapis.com/bit_models/BiT-M-R50x1.npz",
    "resnetv2_50x3_bitm":
        "https://storage.googleapis.com/bit_models/BiT-M-R50x3-ILSVRC2012.npz",
    "resnetv2_50x3_bitm_in21k":
        "https://storage.googleapis.com/bit_models/BiT-M-R50x3.npz",
    "resnetv2_101x1_bitm":
        "https://storage.googleapis.com/bit_models/BiT-M-R101x1-ILSVRC2012.npz",
    "resnetv2_101x1_bitm_in21k":
        "https://storage.googleapis.com/bit_models/BiT-M-R101x1.npz",
    "resnetv2_101x3_bitm":
        "https://storage.googleapis.com/bit_models/BiT-M-R101x3-ILSVRC2012.npz",
    "resnetv2_101x3_bitm_in21k":
        "https://storage.googleapis.com/bit_models/BiT-M-R101x3.npz",
    "resnetv2_152x2_bitm":
        "https://storage.googleapis.com/bit_models/BiT-M-R152x2-ILSVRC2012.npz",
    "resnetv2_152x2_bitm_in21k":
        "https://storage.googleapis.com/bit_models/BiT-M-R152x2.npz",
    "resnetv2_152x4_bitm":
        "https://storage.googleapis.com/bit_models/BiT-M-R152x4-ILSVRC2012.npz",
    "resnetv2_152x4_bitm_in21k":
        "https://storage.googleapis.com/bit_models/BiT-M-R152x4.npz",
    "swin_base_384":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_base_patch4_window12_384_22kto1k.pth",
    "swin_base_patch4_window7_224":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_base_patch4_window7_224_22kto1k.pth",
    "swin_base_patch4_window7_224_in22k":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_base_patch4_window7_224_22k.pth",
    "swin_base_patch4_window12_384":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_base_patch4_window12_384_22kto1k.pth",
    "swin_base_patch4_window12_384_in22k":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_base_patch4_window12_384_22k.pth",
    "swin_large_384":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_large_patch4_window12_384_22kto1k.pth",
    "swin_large_patch4_window7_224":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_large_patch4_window7_224_22kto1k.pth",
    "swin_large_patch4_window7_224_in22k":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_large_patch4_window7_224_22k.pth",
    "swin_large_patch4_window12_384":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_large_patch4_window12_384_22kto1k.pth",
    "swin_large_patch4_window12_384_in22k":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_large_patch4_window12_384_22k.pth",
    "swin_small":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_small_patch4_window7_224.pth",
    "swin_small_patch4_window7_224":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_small_patch4_window7_224.pth",
    "swin_tiny":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_tiny_patch4_window7_224.pth",
    "swin_tiny_patch4_window7_224":
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/swin_tiny_patch4_window7_224.pth",
    "vit_base_patch16_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_p16_224-80ecf9dd.pth",
    "vit_base_patch16_224_in21k":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_patch16_224_in21k-e5005f0a.pth",
    "vit_base_patch16_224_miil":
        "https://miil-public-eu.oss-eu-central-1.aliyuncs.com/model-zoo/ImageNet_21K_P/models/timm/vit_base_patch16_224_1k_miil_84_4.pth",
    "vit_base_patch16_224_miil_in21k":
        "https://miil-public-eu.oss-eu-central-1.aliyuncs.com/model-zoo/ImageNet_21K_P/models/timm/vit_base_patch16_224_in21k_miil.pth",
    "vit_base_patch16_384":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_p16_384-83fb41ba.pth",
    "vit_base_patch32_224_in21k":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_patch32_224_in21k-8db57226.pth",
    "vit_base_patch32_384":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_p32_384-830016f5.pth",
    "vit_base_r50_s16_224_in21k":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_resnet50_224_in21k-6f7c7740.pth",
    "vit_base_r50_s16_384":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_resnet50_384-9fd3c705.pth",
    "vit_base_resnet50_224_in21k":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_resnet50_224_in21k-6f7c7740.pth",
    "vit_base_resnet50_384":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_base_resnet50_384-9fd3c705.pth",
    "vit_deit_base_distilled_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_base_distilled_patch16_224-df68dfff.pth",
    "vit_deit_base_distilled_patch16_384":
        "https://dl.fbaipublicfiles.com/deit/deit_base_distilled_patch16_384-d0272ac0.pth",
    "vit_deit_base_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_base_patch16_224-b5f2ef4d.pth",
    "vit_deit_base_patch16_384":
        "https://dl.fbaipublicfiles.com/deit/deit_base_patch16_384-8de9b5d1.pth",
    "vit_deit_small_distilled_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_small_distilled_patch16_224-649709d9.pth",
    "vit_deit_small_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_small_patch16_224-cd65a155.pth",
    "vit_deit_tiny_distilled_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_tiny_distilled_patch16_224-b40b3cf7.pth",
    "vit_deit_tiny_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_tiny_patch16_224-a1311bcf.pth",
    "vit_huge_patch14_224_in21k":
        "hf_hub:timm/vit_huge_patch14_224_in21k",
    "vit_large_patch16_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_large_p16_224-4ee7a4dc.pth",
    "vit_large_patch16_224_in21k":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_large_patch16_224_in21k-606da67d.pth",
    "vit_large_patch16_384":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_large_p16_384-b3be5167.pth",
    "vit_large_patch32_224_in21k":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_large_patch32_224_in21k-9046d2e7.pth",
    "vit_large_patch32_384":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-vitjx/jx_vit_large_p32_384-9b920ba8.pth",
    "vit_small_patch16_224":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/vit_small_p16_224-15ec54c9.pth",
    "densenet121":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/densenet121_ra-50efcf5c.pth",
    "densenet161":
        "https://download.pytorch.org/models/densenet161-8d451a50.pth",
    "densenet169":
        "https://download.pytorch.org/models/densenet169-b2777c0a.pth",
    "densenet201":
        "https://download.pytorch.org/models/densenet201-c1103571.pth",
    "densenetblur121d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/densenetblur121d_ra-100dcfbc.pth",
    "ecaresnet101d":
        "https://imvl-automl-sh.oss-cn-shanghai.aliyuncs.com/darts/hyperml/hyperml/job_45402/outputs/ECAResNet101D_281c5844.pth",
    "ecaresnet101d_pruned":
        "https://imvl-automl-sh.oss-cn-shanghai.aliyuncs.com/darts/hyperml/hyperml/job_45610/outputs/ECAResNet101D_P_75a3370e.pth",
    "ecaresnet269d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/ecaresnet269d_320_ra2-7baa55cb.pth",
    "ecaresnet26t":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/ecaresnet26t_ra2-46609757.pth",
    "ecaresnet50d":
        "https://imvl-automl-sh.oss-cn-shanghai.aliyuncs.com/darts/hyperml/hyperml/job_45402/outputs/ECAResNet50D_833caf58.pth",
    "ecaresnet50d_pruned":
        "https://imvl-automl-sh.oss-cn-shanghai.aliyuncs.com/darts/hyperml/hyperml/job_45899/outputs/ECAResNet50D_P_9c67f710.pth",
    "ecaresnet50t":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/ecaresnet50t_ra2-f7ac63c4.pth",
    "ecaresnetlight":
        "https://imvl-automl-sh.oss-cn-shanghai.aliyuncs.com/darts/hyperml/hyperml/job_45402/outputs/ECAResNetLight_4f34b35b.pth",
    "gluon_resnet101_v1b":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet101_v1b-3b017079.pth",
    "gluon_resnet101_v1c":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet101_v1c-1f26822a.pth",
    "gluon_resnet101_v1d":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet101_v1d-0f9c8644.pth",
    "gluon_resnet101_v1s":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet101_v1s-60fe0cc1.pth",
    "gluon_resnet152_v1b":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet152_v1b-c1edb0dd.pth",
    "gluon_resnet152_v1c":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet152_v1c-a3bb0b98.pth",
    "gluon_resnet152_v1d":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet152_v1d-bd354e12.pth",
    "gluon_resnet152_v1s":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet152_v1s-dcc41b81.pth",
    "gluon_resnet18_v1b":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet18_v1b-0757602b.pth",
    "gluon_resnet34_v1b":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet34_v1b-c6d82d59.pth",
    "gluon_resnet50_v1b":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet50_v1b-0ebe02e2.pth",
    "gluon_resnet50_v1c":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet50_v1c-48092f55.pth",
    "gluon_resnet50_v1s":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnet50_v1s-1762acc0.pth",
    "gluon_resnext101_32x4d":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnext101_32x4d-b253c8c4.pth",
    "gluon_resnext101_64x4d":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnext101_64x4d-f9a8e184.pth",
    "gluon_resnext50_32x4d":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_resnext50_32x4d-e6a097c1.pth",
    "gluon_senet154":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_senet154-70a1a3c0.pth",
    "gluon_seresnext101_32x4d":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_seresnext101_32x4d-cf52900d.pth",
    "gluon_seresnext101_64x4d":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_seresnext101_64x4d-f9926f93.pth",
    "gluon_seresnext50_32x4d":
        "https://github.com/rwightman/pytorch-pretrained-gluonresnet/releases/download/v0.1/gluon_seresnext50_32x4d-90cf2d6e.pth",
    "ig_resnext101_32x16d":
        "https://download.pytorch.org/models/ig_resnext101_32x16-c6f796b0.pth",
    "ig_resnext101_32x32d":
        "https://download.pytorch.org/models/ig_resnext101_32x32-e4b90b00.pth",
    "ig_resnext101_32x48d":
        "https://download.pytorch.org/models/ig_resnext101_32x48-3e41cc8a.pth",
    "ig_resnext101_32x8d":
        "https://download.pytorch.org/models/ig_resnext101_32x8-c38310e5.pth",
    "resnet101":
        "https://download.pytorch.org/models/resnet101-5d3b4d8f.pth",
    "resnet101d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnet101d_ra2-2803ffab.pth",
    "resnet152":
        "https://download.pytorch.org/models/resnet152-b121ed2d.pth",
    "resnet152d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnet152d_ra2-5cac0439.pth",
    "resnet18":
        "https://download.pytorch.org/models/resnet18-5c106cde.pth",
    "resnet18d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnet18d_ra2-48a79e06.pth",
    "resnet200d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnet200d_ra2-bdba9bf9.pth",
    "resnet26":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnet26-9aa10e23.pth",
    "resnet26d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnet26d-69e92c46.pth",
    "resnet34":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnet34-43635321.pth",
    "resnet34d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnet34d_ra2-f8dcfcaf.pth",
    "resnet50":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnet50_ram-a26f946b.pth",
    "resnet50d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnet50d_ra2-464e36ba.pth",
    "resnetblur50":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnetblur50-84f4748f.pth",
    "resnetrs101":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-rs-weights/resnetrs101_i192_ema-1509bbf6.pth",
    "resnetrs152":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-rs-weights/resnetrs152_i256_ema-a9aff7f9.pth",
    "resnetrs200":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-rs-weights/resnetrs200_ema-623d2f59.pth",
    "resnetrs270":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-rs-weights/resnetrs270_ema-b40e674c.pth",
    "resnetrs350":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-rs-weights/resnetrs350_i256_ema-5a1aa8f1.pth",
    "resnetrs420":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-rs-weights/resnetrs420_ema-972dee69.pth",
    "resnetrs50":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-rs-weights/resnetrs50_ema-6b53758b.pth",
    "resnext101_32x8d":
        "https://download.pytorch.org/models/resnext101_32x8d-8ba56ff5.pth",
    "resnext50_32x4d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnext50_32x4d_ra-d733960d.pth",
    "resnext50d_32x4d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/resnext50d_32x4d-103e99f8.pth",
    "seresnet152d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/seresnet152d_ra2-04464dd2.pth",
    "seresnext26d_32x4d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/seresnext26d_32x4d-80fa48a3.pth",
    "seresnext26t_32x4d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/seresnext26tn_32x4d-569cb627.pth",
    "seresnext26tn_32x4d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/seresnext26tn_32x4d-569cb627.pth",
    "seresnext50_32x4d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/seresnext50_32x4d_racm-a304a460.pth",
    "ssl_resnet18":
        "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/semi_supervised_resnet18-d92f0530.pth",
    "ssl_resnet50":
        "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/semi_supervised_resnet50-08389792.pth",
    "ssl_resnext101_32x16d":
        "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/semi_supervised_resnext101_32x16-15fffa57.pth",
    "ssl_resnext101_32x4d":
        "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/semi_supervised_resnext101_32x4-dc43570a.pth",
    "ssl_resnext101_32x8d":
        "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/semi_supervised_resnext101_32x8-2cfe2f8b.pth",
    "ssl_resnext50_32x4d":
        "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/semi_supervised_resnext50_32x4-ddb3e555.pth",
    "swsl_resnet18":
        "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/semi_weakly_supervised_resnet18-118f1556.pth",
    "swsl_resnet50":
        "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/semi_weakly_supervised_resnet50-16a12f1b.pth",
    "swsl_resnext101_32x16d":
        "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/semi_weakly_supervised_resnext101_32x16-f3559a9c.pth",
    "swsl_resnext101_32x4d":
        "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/semi_weakly_supervised_resnext101_32x4-3f87e46b.pth",
    "swsl_resnext101_32x8d":
        "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/semi_weakly_supervised_resnext101_32x8-b4712904.pth",
    "swsl_resnext50_32x4d":
        "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/semi_weakly_supervised_resnext50_32x4-72679e44.pth",
    "tv_densenet121":
        "https://download.pytorch.org/models/densenet121-a639ec97.pth",
    "tv_resnet101":
        "https://download.pytorch.org/models/resnet101-5d3b4d8f.pth",
    "tv_resnet152":
        "https://download.pytorch.org/models/resnet152-b121ed2d.pth",
    "tv_resnet34":
        "https://download.pytorch.org/models/resnet34-333f7ec4.pth",
    "tv_resnet50":
        "https://download.pytorch.org/models/resnet50-19c8e357.pth",
    "tv_resnext50_32x4d":
        "https://download.pytorch.org/models/resnext50_32x4d-7cdf4587.pth",
    "vgg11":
        "https://download.pytorch.org/models/vgg11-bbd30ac9.pth",
    "vgg11_bn":
        "https://download.pytorch.org/models/vgg11_bn-6002323d.pth",
    "vgg13":
        "https://download.pytorch.org/models/vgg13-c768596a.pth",
    "vgg13_bn":
        "https://download.pytorch.org/models/vgg13_bn-abd245e5.pth",
    "vgg16":
        "https://download.pytorch.org/models/vgg16-397923af.pth",
    "vgg16_bn":
        "https://download.pytorch.org/models/vgg16_bn-6c64b313.pth",
    "vgg19":
        "https://download.pytorch.org/models/vgg19-dcbb9e9d.pth",
    "vgg19_bn":
        "https://download.pytorch.org/models/vgg19_bn-c79401a0.pth",
    "wide_resnet101_2":
        "https://download.pytorch.org/models/wide_resnet101_2-32ee1156.pth",
    "wide_resnet50_2":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/wide_resnet50_racm-8234f177.pth",
    "efficientnet_b0":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/efficientnet_b0_ra-3dd342df.pth",
    "efficientnet_b1":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/efficientnet_b1-533bc792.pth",
    "efficientnet_b2":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/efficientnet_b2_ra-bcdf34b7.pth",
    "efficientnet_b3":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/efficientnet_b3_ra2-cf984f9c.pth",
    "legacy_senet154":
        "http://data.lip6.fr/cadene/pretrainedmodels/senet154-c7b49a05.pth",
    "legacy_seresnet101":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-cadene/se_resnet101-7e38fcc6.pth",
    "legacy_seresnet152":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-cadene/se_resnet152-d17c99b7.pth",
    "legacy_seresnet18":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/seresnet18-4bb0ce65.pth",
    "legacy_seresnet34":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/seresnet34-a4004e63.pth",
    "legacy_seresnet50":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-cadene/se_resnet50-ce0d4300.pth",
    "legacy_seresnext101_32x4d":
        "http://data.lip6.fr/cadene/pretrainedmodels/se_resnext101_32x4d-3b2fe3d8.pth",
    "legacy_seresnext26_32x4d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/seresnext26_32x4d-65ebdb501.pth",
    "legacy_seresnext50_32x4d":
        "http://data.lip6.fr/cadene/pretrainedmodels/se_resnext50_32x4d-a260b3a4.pth",
    "mobilenetv3_large_100":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/mobilenetv3_large_100_ra-f55367f5.pth",
    "mobilenetv3_large_100_miil":
        "https://miil-public-eu.oss-eu-central-1.aliyuncs.com/model-zoo/ImageNet_21K_P/models/timm/mobilenetv3_large_100_1k_miil_78_0.pth",
    "mobilenetv3_large_100_miil_in21k":
        "https://miil-public-eu.oss-eu-central-1.aliyuncs.com/model-zoo/ImageNet_21K_P/models/timm/mobilenetv3_large_100_in21k_miil.pth",
    "regnetx_002":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-regnet/regnetx_002-e7e85e5c.pth",
    "regnetx_032":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-regnet/regnetx_032-ed0c7f7e.pth",
    "regnety_002":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-regnet/regnety_002-e68ca334.pth",
    "res2net101_26w_4s":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-res2net/res2net101_26w_4s-02a759a1.pth",
    "res2net50":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-res2net/res2net50_26w_4s-06e79181.pth",
    "res2net50_14w_8s":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-res2net/res2net50_14w_8s-6527dddc.pth",
    "res2net50_26w_4s":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-res2net/res2net50_26w_4s-06e79181.pth",
    "res2net50_26w_6s":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-res2net/res2net50_26w_6s-19041792.pth",
    "res2net50_26w_8s":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-res2net/res2net50_26w_8s-2c7c9f12.pth",
    "res2net50_48w_2s":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-res2net/res2net50_48w_2s-afed724a.pth",
    "res2next50":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-res2net/res2next50_4s-6ef7e7bf.pth",
    "resnest101e":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-resnest/resnest101-22405ba7.pth",
    "resnest14d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/gluon_resnest14-9c8fe254.pth",
    "resnest200e":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-resnest/resnest200-75117900.pth",
    "resnest269e":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-resnest/resnest269-0cc87c48.pth",
    "resnest26d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/gluon_resnest26-50eb607c.pth",
    "resnest50d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-resnest/resnest50-528c19ca.pth",
    "resnest50d_1s4x24d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-resnest/resnest50_fast_1s4x24d-d4a4f76f.pth",
    "resnest50d_4s2x40d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-resnest/resnest50_fast_4s2x40d-41d14ed0.pth",
    "seresnet50":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/seresnet50_ra_224-8efdb4bb.pth",
    "skresnet18":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/skresnet18_ra-4eec2804.pth",
    "skresnet34":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/skresnet34_ra-bdc0ccde.pth",
    "skresnext50_32x4d":
        "https://github.com/rwightman/pytorch-image-models/releases/download/v0.1-weights/skresnext50_ra-f40e40bf.pth",
}


def zoo_dir() -> str:
    return os.environ.get("ACR_WSSS_ZOO",
                          os.path.join(os.path.expanduser("~"), ".cache", "acr_wsss_tpu", "zoo"))


def npz_path(backbone: str, directory: Optional[str] = None) -> str:
    return os.path.join(directory or zoo_dir(), f"{backbone}_in21k.npz")


# JAX sends the other efficientnet_* names and these MobileNetV3s to its
# generic EfficientNet mapper (``zoo.py:751-770``), which the port lacks.
_EFFICIENTNET_MAPPED = frozenset(f"efficientnet_b{i}" for i in range(5))
_GENERIC_MOBILENETV3 = frozenset(("mobilenetv3_large_075", "mobilenetv3_rw",
                                  "mobilenetv3_small_075", "mobilenetv3_small_100"))


def convert_state_dict(backbone: str, state: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A timm state dict of the registry name ``backbone`` as its flat flax
    dict, by the mapper of its family, in JAX's order (``zoo.py:648-862``):
    the timm ResNet constructor's names first (so that resnet50d does not
    fall to the torchvision layout), then Swin, PiT, ViT/DeiT, BiT, the
    torchvision ResNets and their aliases, the legacy SENets, SEResNet,
    Res2Net and ResNeSt, EfficientNet b0-b4, VGG, DenseNet, RegNet, the
    SK-ResNets, MobileNetV3. As in JAX, sknet50 and res2next50 match no
    rule."""
    from acr_wsss_tpu_torch.models.resnet_timm import _TIMM_RESNET_CFGS

    if backbone in _TIMM_RESNET_CFGS:
        return timm_resnet_state_dict_to_flax(state)
    if backbone.startswith("swin"):
        return swin_state_dict_to_flax(state)
    if backbone.startswith("pit"):
        return pit_state_dict_to_flax(state)
    if backbone.startswith("vit_"):
        return vit_timm_state_dict_to_flax(state)
    if backbone.startswith("resnetv2") and "_bitm" in backbone:
        return resnetv2_bit_state_dict_to_flax(state)
    if backbone.startswith(("resnet", "resnext", "wide_resnet", "tv_resnet", "tv_resnext",
                            "ssl_resne", "swsl_resne", "ig_resnext")) \
            and not backbone.startswith("resnetv2"):
        return resnet_state_dict_to_flax(state)
    if backbone.startswith(("legacy_seresnet", "legacy_senet", "legacy_seresnext")):
        return legacy_senet_state_dict_to_flax(state)
    if backbone.startswith(("seresnet", "res2net", "resnest")):
        return attn_resnet_state_dict_to_flax(state)
    if backbone in _EFFICIENTNET_MAPPED:
        return efficientnet_state_dict_to_flax(state)
    if backbone.startswith("vgg"):
        return vgg_state_dict_to_flax(state)
    if backbone.startswith(("densenet", "tv_densenet")):
        return densenet_state_dict_to_flax(state)
    if backbone.startswith("regnet"):
        return regnet_state_dict_to_flax(state)
    if backbone.startswith(("skresnet", "skresnext")):
        return sknet_state_dict_to_flax(state)
    if backbone.startswith("mobilenetv3") and backbone not in _GENERIC_MOBILENETV3:
        return mobilenetv3_state_dict_to_flax(state)
    raise ValueError(f"no timm checkpoint mapper for {backbone!r} in the port: it maps the "
                     "swin_*, pit_*, vit_*, resnetv2_*_bitm names and the CNN families "
                     "(resnetv2_50 and resnetv2_101 load from a flat flax .npz)")


def _validate_checkpoint_file(path: str) -> None:
    """Raise on a file too small to be a checkpoint (a truncated copy or an
    error page), and on one whose sha256 does not start with the 8 hex
    digits of a timm file name (``...-83fb41ba.pth``)."""
    size = os.path.getsize(path)
    if size < 1 << 20:
        raise RuntimeError(f"{path} is only {size} bytes: truncated, or an error page. "
                           "Delete it and fetch it again.")
    m = re.search(r"-([0-9a-f]{8})\.pth$", os.path.basename(path))
    if m:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if not h.hexdigest().startswith(m[1]):
            raise RuntimeError(f"{path}: sha256 {h.hexdigest()[:8]} is not the file name's "
                               f"{m[1]}: a corrupt copy. Delete it and fetch it again.")


def fetch(backbone: str, directory: Optional[str] = None, url: Optional[str] = None) -> str:
    """The zoo npz of ``backbone``, converted at first use from its
    checkpoint: ``<directory>/<basename of url>``, copied there from a
    ``file://`` URL when it is not there yet (``url`` or ``ZOO_URLS``).
    Returns the npz's path. Any other URL raises: nothing is downloaded."""
    url = url or ZOO_URLS.get(backbone)
    if not url:
        raise ValueError(f"no zoo URL for backbone {backbone!r}")
    if url.startswith("hf_hub:"):
        raise NotImplementedError(f"{backbone!r} ships by the hf_hub: source ({url}), which "
                                  "the port does not fetch")
    directory = directory or zoo_dir()
    os.makedirs(directory, exist_ok=True)
    out = npz_path(backbone, directory)
    if os.path.exists(out):
        return out
    path = os.path.join(directory, os.path.basename(url))
    if not os.path.exists(path):
        if not url.startswith("file://"):
            raise RuntimeError(f"{path} not found, and the port downloads nothing: put the "
                               f"file of {url} there, or pass url='file://<path>'")
        shutil.copyfile(url[len("file://"):], path + ".part")
        os.replace(path + ".part", path)
    _validate_checkpoint_file(path)
    if path.endswith(".npz"):           # BiT ships TF-layout npz files
        with np.load(path) as f:
            state = bit_npz_to_torch_names(dict(f))
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("model", "state_dict"):
            if isinstance(state, dict) and key in state:
                state = state[key]
    save_params_npz(out, convert_state_dict(backbone, state))
    return out


def load_backbone_params(backbone: str, directory: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The zoo npz as a flat ``{flax_path: array}`` dict."""
    path = npz_path(backbone, directory)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found; write it with the JAX package's "
                                f"`python -m acr_wsss_tpu.models.zoo fetch {backbone}`")
    return load_params_npz(path)


def init_with_pretrained(model: nn.Module, seed: int, directory: Optional[str] = None
                         ) -> nn.Module:
    """``init_random_(model, seed)``, then every trunk parameter from the
    zoo npz of ``model.backbone_name``; the head stays as the seed made it.
    Raises if the npz's trunk and the model's differ in a name or shape."""
    init_random_(model, seed)
    pretrained = scanned_to_unrolled(load_backbone_params(model.backbone_name, directory))
    flat = state_dict_to_flax(model)
    want = {k for k in flat if k.startswith(TRUNK)}
    have = {k for k in pretrained if k.startswith(TRUNK)}
    if want != have:
        raise ValueError(f"zoo npz trunk does not match the model: missing "
                         f"{sorted(want - have)[:8]}, unused {sorted(have - want)[:8]}")
    flat.update({k: pretrained[k] for k in want})
    model.load_state_dict(flax_to_state_dict(flat, model.state_dict()))
    return model


def _triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of JAX's ``compute_weight_mat`` for the
    triangle kernel with antialiasing (``jax/_src/image/scale.py``): the
    kernel widened by in/out when shrinking, each column normalized, and
    columns whose sample lies outside the input zeroed."""
    inv_scale = np.float32(in_size / out_size)
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / max(
        inv_scale, np.float32(1.0))
    weights = np.maximum(np.float32(0.0), 1 - x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def resize_bilinear_antialiased(x: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.image.resize(x, shape, "bilinear")`` in numpy float32: each
    axis whose size changes contracted with its triangle weights (which
    antialias when the axis shrinks)."""
    out = np.asarray(x, np.float32)
    for axis, size in enumerate(shape):
        if out.shape[axis] != size:
            w = _triangle_weights(out.shape[axis], size)
            out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
    return out


def graft_standalone(model: nn.Module, flat: Dict[str, np.ndarray], verbose: bool = True
                     ) -> nn.Module:
    """Put the flat flax npz ``flat`` onto ``model`` (a model of the
    registry) in place, as JAX's ``graft_standalone``: entries whose shapes
    match are copied; a 4-D ``pos_embed`` of the model's channel count is
    resized over its grid; every other entry (the ImageNet head at another
    class count, names the model lacks) is reported and its parameter
    keeps the model's init."""
    params = state_dict_to_flax(model)
    skipped = []
    for path, leaf in flat.items():
        leaf = np.asarray(leaf)
        if path not in params:
            skipped.append((path, "no target"))
        elif params[path].shape == leaf.shape:
            params[path] = leaf.astype(np.float32)
        elif (path.endswith("/pos_embed") and leaf.ndim == 4
              and params[path].shape[-1] == leaf.shape[-1]):
            params[path] = resize_bilinear_antialiased(leaf, params[path].shape)
        else:
            skipped.append((path, f"{leaf.shape} vs {params[path].shape}"))
    if verbose and skipped:
        print("zoo graft skipped:", skipped, flush=True)
    model.load_state_dict(flax_to_state_dict(params, model.state_dict()))
    return model
