"""Data-generating processes and estimators of the port."""
