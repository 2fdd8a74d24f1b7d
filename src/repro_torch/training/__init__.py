"""Training-side utilities the serving slice needs (synthetic data)."""
