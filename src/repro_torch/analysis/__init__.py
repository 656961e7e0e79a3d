"""Schedule analysis (the structural check; the passes come later)."""
