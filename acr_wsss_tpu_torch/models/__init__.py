"""Models of the port: the ACR classifier and its ViT / ResNetV2 trunk."""
