"""The ViT: layers, attention references, params and the oracle forward."""
