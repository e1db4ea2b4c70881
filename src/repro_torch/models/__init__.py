"""Model side of the port: the parameter-spec system and the dense decoder
transformer (prefill -> decode serving path)."""
