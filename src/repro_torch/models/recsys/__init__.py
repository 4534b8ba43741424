"""Recommendation models: DeepFM over sparse embedding tables."""
