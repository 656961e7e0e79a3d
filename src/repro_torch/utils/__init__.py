"""Tree naming and weight conversion helpers."""
