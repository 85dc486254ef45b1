"""Per-model data configuration ("default_cfg"): the port of
``acr_wsss_tpu/models/cfg.py``, whole.

timm attaches a ``default_cfg`` to every registered model: published facts
about its pretrained checkpoint that say how to feed it (input size,
center-crop fraction, resize interpolation, normalization statistics, the
label space). These are plain rules, family by family, with a per-name
table of exceptions; ``url`` is the zoo's (``models/zoo.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)
IMAGENET_DPN_MEAN = (124 / 255, 117 / 255, 104 / 255)
IMAGENET_DPN_STD = tuple(1 / (0.0167 * 255) for _ in range(3))


def _zero_one_stats(n: str) -> bool:
    # MIIL releases and TResNet train/eval on raw [0, 1] inputs.
    return "miil" in n or n.startswith("tresnet")


def _inception_stats(n: str) -> bool:
    if _zero_one_stats(n):
        return False
    if n.startswith("vit_"):
        # DeiT, the original vit_small, and the resnetXXd-stem hybrids
        # keep ImageNet statistics; every other ViT release is 0.5-normed.
        if "deit" in n:
            return False
        if re.search(r"resnet\d+d", n):
            return False
        return n != "vit_small_patch16_224"
    if n.startswith(("inception_", "adv_inception", "tf_inception",
                     "ens_adv_inception")):
        return True
    if n in ("nasnetalarge", "pnasnet5large"):
        return True
    if n.startswith("xception"):
        return True
    if "_bitm" in n:  # BiT: big-transfer releases
        return True
    if n.startswith(("tf_efficientnet_cc", "tf_efficientnet_lite",
                     "tf_efficientnet_e", "tf_mobilenetv3")):
        return True
    if n.startswith("tf_efficientnet_b") and n.endswith("_ap"):
        return True
    if n.startswith("efficientnet_b") and n.endswith("_pruned"):
        return True
    return False


_BILINEAR_PREFIXES = (
    "dla", "hrnet_", "vgg", "repvgg_", "resnetv2_", "tresnet_", "ghostnet_",
    "hardcorenas_", "gernet_", "csp", "darknet", "tf_mobilenetv3_",
    "fbnetc_", "spnasnet_", "legacy_se", "tv_resn", "ssl_", "swsl_", "ig_",
    "resnest", "mobilenetv3_large_075", "mobilenetv3_small_",
)
_BILINEAR_NAMES = frozenset((
    "resnet18", "resnet34", "wide_resnet101_2", "resnext101_32x8d",
    "mobilenetv3_large_100", "vit_base_patch32_224",
    "vit_base_patch32_224_in21k",
))


def _bilinear(n: str) -> bool:
    if n == "legacy_seresnet18":
        return False
    return n.startswith(_BILINEAR_PREFIXES) or n in _BILINEAR_NAMES


# Per-name (input_size, crop_pct, interpolation) where the family rules do
# not apply -- published per-checkpoint eval resolutions/crops (e.g. the
# EfficientNet compound-scaling resolutions, NFNet test crops, the
# ResNet-D 256/1.0 evals).
_CFG_EXCEPTIONS: Dict[str, Tuple[int, float, str]] = {
    "cspdarknet53": (256, 0.887, "bilinear"),
    "cspdarknet53_iabn": (256, 0.887, "bilinear"),
    "cspresnet50": (256, 0.887, "bilinear"),
    "cspresnet50d": (256, 0.887, "bilinear"),
    "cspresnet50w": (256, 0.887, "bilinear"),
    "cspresnext50_iabn": (256, 0.887, "bilinear"),
    "darknet53": (256, 0.887, "bilinear"),
    "dm_nfnet_f0": (192, 0.9, "bicubic"),
    "dm_nfnet_f1": (224, 0.91, "bicubic"),
    "dm_nfnet_f2": (256, 0.92, "bicubic"),
    "dm_nfnet_f3": (320, 0.94, "bicubic"),
    "dm_nfnet_f4": (384, 0.951, "bicubic"),
    "dm_nfnet_f5": (416, 0.954, "bicubic"),
    "dm_nfnet_f6": (448, 0.956, "bicubic"),
    "eca_nfnet_l0": (224, 1.0, "bicubic"),
    "eca_nfnet_l1": (256, 1.0, "bicubic"),
    "ecaresnet200d": (256, 0.94, "bicubic"),
    "ecaresnet269d": (320, 1.0, "bicubic"),
    "ecaresnet26t": (256, 0.95, "bicubic"),
    "ecaresnet50t": (256, 0.95, "bicubic"),
    "efficientnet_b1": (224, 1.0, "bicubic"),
    "efficientnet_b1_pruned": (240, 0.882, "bicubic"),
    "efficientnet_b2": (256, 1.0, "bicubic"),
    "efficientnet_b2_pruned": (260, 0.89, "bicubic"),
    "efficientnet_b3": (288, 1.0, "bicubic"),
    "efficientnet_b3_pruned": (300, 0.904, "bicubic"),
    "efficientnet_b4": (320, 1.0, "bicubic"),
    "efficientnet_b5": (456, 0.934, "bicubic"),
    "efficientnet_b6": (528, 0.942, "bicubic"),
    "efficientnet_b7": (600, 0.949, "bicubic"),
    "efficientnet_b8": (672, 0.954, "bicubic"),
    "efficientnet_cc_b1_8e": (240, 0.882, "bicubic"),
    "efficientnet_el": (300, 0.904, "bicubic"),
    "efficientnet_el_pruned": (300, 0.904, "bicubic"),
    "efficientnet_em": (240, 0.882, "bicubic"),
    "efficientnet_l2": (800, 0.961, "bicubic"),
    "efficientnet_lite1": (240, 0.882, "bicubic"),
    "efficientnet_lite2": (260, 0.89, "bicubic"),
    "efficientnet_lite3": (300, 0.904, "bicubic"),
    "efficientnet_lite4": (380, 0.922, "bicubic"),
    "efficientnet_v2s": (288, 1.0, "bicubic"),
    "ens_adv_inception_resnet_v2": (299, 0.8975, "bicubic"),
    "gernet_l": (256, 0.875, "bilinear"),
    "gluon_xception65": (299, 0.903, "bicubic"),
    "halonet26t": (256, 0.875, "bicubic"),
    "halonet_h1": (256, 0.875, "bicubic"),
    "halonet_h1_c4c5": (256, 0.875, "bicubic"),
    "inception_resnet_v2": (299, 0.8975, "bicubic"),
    "lambda_resnet26t": (256, 0.875, "bicubic"),
    "legacy_seresnext26_32x4d": (224, 0.875, "bicubic"),
    "mobilenetv3_large_100": (224, 0.875, "bicubic"),
    "mobilenetv3_large_100_miil": (224, 0.875, "bilinear"),
    "mobilenetv3_large_100_miil_in21k": (224, 0.875, "bilinear"),
    "nasnetalarge": (331, 0.911, "bicubic"),
    "nf_ecaresnet101": (224, 0.9, "bicubic"),
    "nf_ecaresnet26": (224, 0.9, "bicubic"),
    "nf_ecaresnet50": (224, 0.9, "bicubic"),
    "nf_regnet_b0": (192, 0.9, "bicubic"),
    "nf_regnet_b1": (256, 0.9, "bicubic"),
    "nf_regnet_b2": (240, 0.9, "bicubic"),
    "nf_regnet_b3": (288, 0.9, "bicubic"),
    "nf_regnet_b4": (320, 0.9, "bicubic"),
    "nf_regnet_b5": (384, 0.9, "bicubic"),
    "nf_resnet101": (224, 0.9, "bicubic"),
    "nf_resnet26": (224, 0.9, "bicubic"),
    "nf_resnet50": (256, 0.94, "bicubic"),
    "nf_seresnet101": (224, 0.9, "bicubic"),
    "nf_seresnet26": (224, 0.9, "bicubic"),
    "nf_seresnet50": (224, 0.9, "bicubic"),
    "nfnet_f0": (192, 0.9, "bicubic"),
    "nfnet_f0s": (192, 0.9, "bicubic"),
    "nfnet_f1": (224, 0.9, "bicubic"),
    "nfnet_f1s": (224, 0.9, "bicubic"),
    "nfnet_f2": (256, 0.9, "bicubic"),
    "nfnet_f2s": (256, 0.9, "bicubic"),
    "nfnet_f3": (320, 0.9, "bicubic"),
    "nfnet_f3s": (320, 0.9, "bicubic"),
    "nfnet_f4": (384, 0.9, "bicubic"),
    "nfnet_f4s": (384, 0.9, "bicubic"),
    "nfnet_f5": (416, 0.9, "bicubic"),
    "nfnet_f5s": (416, 0.9, "bicubic"),
    "nfnet_f6": (448, 0.9, "bicubic"),
    "nfnet_f6s": (448, 0.9, "bicubic"),
    "nfnet_f7": (480, 0.9, "bicubic"),
    "nfnet_f7s": (480, 0.9, "bicubic"),
    "nfnet_l0": (224, 1.0, "bicubic"),
    "pit_b_224": (224, 0.9, "bicubic"),
    "pit_b_distilled_224": (224, 0.9, "bicubic"),
    "pit_s_224": (224, 0.9, "bicubic"),
    "pit_s_distilled_224": (224, 0.9, "bicubic"),
    "pit_ti_224": (224, 0.9, "bicubic"),
    "pit_ti_distilled_224": (224, 0.9, "bicubic"),
    "pit_xs_224": (224, 0.9, "bicubic"),
    "pit_xs_distilled_224": (224, 0.9, "bicubic"),
    "pnasnet5large": (331, 0.911, "bicubic"),
    "regnetx_320": (224, 0.875, "bicubic"),
    "regnety_032": (224, 1.0, "bicubic"),
    "regnety_160": (224, 1.0, "bicubic"),
    "regnety_320": (224, 0.875, "bicubic"),
    "res2net101_26w_4s": (224, 0.875, "bilinear"),
    "res2net50_14w_8s": (224, 0.875, "bilinear"),
    "res2net50_26w_4s": (224, 0.875, "bilinear"),
    "res2net50_26w_6s": (224, 0.875, "bilinear"),
    "res2net50_26w_8s": (224, 0.875, "bilinear"),
    "res2net50_48w_2s": (224, 0.875, "bilinear"),
    "res2next50": (224, 0.875, "bilinear"),
    "resnest101e": (256, 0.875, "bilinear"),
    "resnest200e": (320, 0.909, "bicubic"),
    "resnest269e": (416, 0.928, "bicubic"),
    "resnest50d_1s4x24d": (224, 0.875, "bicubic"),
    "resnest50d_4s2x40d": (224, 0.875, "bicubic"),
    "resnet101d": (256, 1.0, "bicubic"),
    "resnet152d": (256, 1.0, "bicubic"),
    "resnet200d": (256, 1.0, "bicubic"),
    "resnetrs101": (192, 0.94, "bicubic"),
    "resnetrs152": (256, 1.0, "bicubic"),
    "resnetrs200": (256, 1.0, "bicubic"),
    "resnetrs270": (256, 1.0, "bicubic"),
    "resnetrs350": (288, 1.0, "bicubic"),
    "resnetrs420": (320, 1.0, "bicubic"),
    "resnetrs50": (160, 0.91, "bicubic"),
    "resnetv2_101x1_bitm": (480, 1.0, "bilinear"),
    "resnetv2_101x1_bitm_in21k": (480, 1.0, "bilinear"),
    "resnetv2_101x3_bitm": (480, 1.0, "bilinear"),
    "resnetv2_101x3_bitm_in21k": (480, 1.0, "bilinear"),
    "resnetv2_152x2_bitm": (480, 1.0, "bilinear"),
    "resnetv2_152x2_bitm_in21k": (480, 1.0, "bilinear"),
    "resnetv2_152x4_bitm": (480, 1.0, "bilinear"),
    "resnetv2_152x4_bitm_in21k": (480, 1.0, "bilinear"),
    "resnetv2_50x1_bitm": (480, 1.0, "bilinear"),
    "resnetv2_50x1_bitm_in21k": (480, 1.0, "bilinear"),
    "resnetv2_50x3_bitm": (480, 1.0, "bilinear"),
    "resnetv2_50x3_bitm_in21k": (480, 1.0, "bilinear"),
    "resnext101_32x4d": (224, 0.875, "bilinear"),
    "resnext101_64x4d": (224, 0.875, "bilinear"),
    "seresnet152d": (256, 1.0, "bicubic"),
    "seresnet200d": (256, 0.94, "bicubic"),
    "seresnet269d": (256, 0.94, "bicubic"),
    "swin_base_patch4_window12_384": (384, 1.0, "bicubic"),
    "swin_base_patch4_window12_384_in22k": (384, 1.0, "bicubic"),
    "swin_base_patch4_window7_224": (224, 0.9, "bicubic"),
    "swin_base_patch4_window7_224_in22k": (224, 0.9, "bicubic"),
    "swin_large_patch4_window12_384": (384, 1.0, "bicubic"),
    "swin_large_patch4_window12_384_in22k": (384, 1.0, "bicubic"),
    "swin_large_patch4_window7_224": (224, 0.9, "bicubic"),
    "swin_large_patch4_window7_224_in22k": (224, 0.9, "bicubic"),
    "swin_small_patch4_window7_224": (224, 0.9, "bicubic"),
    "swin_tiny_patch4_window7_224": (224, 0.9, "bicubic"),
    "tf_efficientnet_b1": (240, 0.882, "bicubic"),
    "tf_efficientnet_b1_ap": (240, 0.882, "bicubic"),
    "tf_efficientnet_b1_ns": (240, 0.882, "bicubic"),
    "tf_efficientnet_b2": (260, 0.89, "bicubic"),
    "tf_efficientnet_b2_ap": (260, 0.89, "bicubic"),
    "tf_efficientnet_b2_ns": (260, 0.89, "bicubic"),
    "tf_efficientnet_b3": (300, 0.904, "bicubic"),
    "tf_efficientnet_b3_ap": (300, 0.904, "bicubic"),
    "tf_efficientnet_b3_ns": (300, 0.904, "bicubic"),
    "tf_efficientnet_b4": (380, 0.922, "bicubic"),
    "tf_efficientnet_b4_ap": (380, 0.922, "bicubic"),
    "tf_efficientnet_b4_ns": (380, 0.922, "bicubic"),
    "tf_efficientnet_b5": (456, 0.934, "bicubic"),
    "tf_efficientnet_b5_ap": (456, 0.934, "bicubic"),
    "tf_efficientnet_b5_ns": (456, 0.934, "bicubic"),
    "tf_efficientnet_b6": (528, 0.942, "bicubic"),
    "tf_efficientnet_b6_ap": (528, 0.942, "bicubic"),
    "tf_efficientnet_b6_ns": (528, 0.942, "bicubic"),
    "tf_efficientnet_b7": (600, 0.949, "bicubic"),
    "tf_efficientnet_b7_ap": (600, 0.949, "bicubic"),
    "tf_efficientnet_b7_ns": (600, 0.949, "bicubic"),
    "tf_efficientnet_b8": (672, 0.954, "bicubic"),
    "tf_efficientnet_b8_ap": (672, 0.954, "bicubic"),
    "tf_efficientnet_cc_b1_8e": (240, 0.882, "bicubic"),
    "tf_efficientnet_el": (300, 0.904, "bicubic"),
    "tf_efficientnet_em": (240, 0.882, "bicubic"),
    "tf_efficientnet_l2_ns": (800, 0.96, "bicubic"),
    "tf_efficientnet_l2_ns_475": (475, 0.936, "bicubic"),
    "tf_efficientnet_lite1": (240, 0.882, "bicubic"),
    "tf_efficientnet_lite2": (260, 0.89, "bicubic"),
    "tf_efficientnet_lite3": (300, 0.904, "bilinear"),
    "tf_efficientnet_lite4": (380, 0.92, "bilinear"),
    "vit_base_patch16_224": (224, 0.9, "bicubic"),
    "vit_base_patch16_224_in21k": (224, 0.9, "bicubic"),
    "vit_base_patch16_224_miil": (224, 0.875, "bilinear"),
    "vit_base_patch16_224_miil_in21k": (224, 0.875, "bilinear"),
    "vit_base_patch16_384": (384, 1.0, "bicubic"),
    "vit_base_patch32_224": (224, 0.9, "bicubic"),
    "vit_base_patch32_224_in21k": (224, 0.9, "bicubic"),
    "vit_base_patch32_384": (384, 1.0, "bicubic"),
    "vit_base_r20_s16_224": (224, 0.9, "bicubic"),
    "vit_base_r26_s32_224": (224, 0.9, "bicubic"),
    "vit_base_r50_s16_224": (224, 0.9, "bicubic"),
    "vit_base_r50_s16_224_in21k": (224, 0.9, "bicubic"),
    "vit_base_r50_s16_384": (384, 1.0, "bicubic"),
    "vit_base_resnet26d_224": (224, 0.9, "bicubic"),
    "vit_base_resnet50d_224": (224, 0.9, "bicubic"),
    "vit_deit_base_distilled_patch16_224": (224, 0.9, "bicubic"),
    "vit_deit_base_distilled_patch16_384": (384, 1.0, "bicubic"),
    "vit_deit_base_patch16_224": (224, 0.9, "bicubic"),
    "vit_deit_base_patch16_384": (384, 1.0, "bicubic"),
    "vit_deit_small_distilled_patch16_224": (224, 0.9, "bicubic"),
    "vit_deit_small_patch16_224": (224, 0.9, "bicubic"),
    "vit_deit_tiny_distilled_patch16_224": (224, 0.9, "bicubic"),
    "vit_deit_tiny_patch16_224": (224, 0.9, "bicubic"),
    "vit_huge_patch14_224_in21k": (224, 0.9, "bicubic"),
    "vit_large_patch16_224": (224, 0.9, "bicubic"),
    "vit_large_patch16_224_in21k": (224, 0.9, "bicubic"),
    "vit_large_patch16_384": (384, 1.0, "bicubic"),
    "vit_large_patch32_224": (224, 0.9, "bicubic"),
    "vit_large_patch32_224_in21k": (224, 0.9, "bicubic"),
    "vit_large_patch32_384": (384, 1.0, "bicubic"),
    "vit_large_r50_s32_224": (224, 0.9, "bicubic"),
    "vit_small_patch16_224": (224, 0.9, "bicubic"),
    "vit_small_r20_s16_224": (224, 0.9, "bicubic"),
    "vit_small_r20_s16_p2_224": (224, 0.9, "bicubic"),
    "vit_small_r26_s32_224": (224, 0.9, "bicubic"),
    "vit_small_r_s16_p8_224": (224, 0.9, "bicubic"),
    "vit_small_resnet26d_224": (224, 0.9, "bicubic"),
    "vit_small_resnet50d_s16_224": (224, 0.9, "bicubic"),
    "vit_tiny_r_s16_p8_224": (224, 0.9, "bicubic"),
    "xception": (299, 0.8975, "bicubic"),
    "xception41": (299, 0.903, "bicubic"),
    "xception65": (299, 0.903, "bicubic"),
    "xception71": (299, 0.903, "bicubic"),
}


def _rule_cfg(name: str):
    base = re.sub(r"_in2[12]k$", "", name)
    m = re.search(r"_(\d{3})$", base)
    if m and int(m.group(1)) >= 224:  # width suffixes (_050.._200) are not sizes
        size = int(m.group(1))
    elif re.search(r"(inception|xception)", name):
        size = 299
    elif name in ("nasnetalarge", "pnasnet5large"):
        size = 331
    else:
        size = 224
    return size, 0.875, "bilinear" if _bilinear(name) else "bicubic"


def default_cfg(name: str) -> Optional[Dict]:
    """timm-shaped data cfg for a registered model name, or None.

    Names outside the reference zoo surface (the ACR aliases, scanned
    variants, ...) get the family rules too -- the dict is a preprocessing
    recipe, not a registry gate.
    """
    size, crop, interp = _CFG_EXCEPTIONS.get(name) or _rule_cfg(name)
    if _zero_one_stats(name):
        mean, std = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    elif name.startswith("dpn") and name != "dpn68b":
        mean, std = IMAGENET_DPN_MEAN, IMAGENET_DPN_STD
    elif _inception_stats(name):
        mean, std = IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD
    else:
        mean, std = IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
    num_classes = 1000
    if name.endswith("_in21k"):
        num_classes = 11221 if "miil" in name else 21843
    if name.endswith("_in22k"):
        num_classes = 21841
    from acr_wsss_tpu_torch.models import zoo
    return {
        "url": zoo.ZOO_URLS.get(name, ""),
        "num_classes": num_classes,
        "input_size": (3, size, size),
        "crop_pct": crop,
        "interpolation": interp,
        "mean": mean,
        "std": std,
    }
