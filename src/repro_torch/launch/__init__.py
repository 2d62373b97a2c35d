"""Entry points of the port (serving and training)."""
