"""Process-group setup and the training launcher."""
