"""Model building blocks of the port: the conv trunk's layers and the LM
substrate (``common``, ``layers``, ``lm``, ``whisper``)."""
