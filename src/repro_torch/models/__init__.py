"""The dense decoder of the port (layers + ragged LM step)."""
