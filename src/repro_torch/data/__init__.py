"""The staged training-data pipeline."""
