"""Models of the port: the DALLE cached decode path and the dVAE decoder."""
