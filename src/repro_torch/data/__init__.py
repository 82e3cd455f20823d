"""The synthetic training data pipeline."""
