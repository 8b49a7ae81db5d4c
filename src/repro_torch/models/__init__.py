"""Models of the port: layers, the LM (cache-free forward and ragged
serving step) and ``api.build_model``."""
