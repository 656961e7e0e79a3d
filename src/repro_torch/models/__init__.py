"""Model families (ResNet so far)."""
