"""Entry points of the port that drive a model."""
