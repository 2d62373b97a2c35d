"""Model building blocks of the port (the conv trunk's pooling so far)."""
