"""Language models of the port (the dense family so far)."""
