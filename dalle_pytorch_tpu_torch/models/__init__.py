"""Models of the port: the DALLE transformer, the dVAE decoder and CLIP."""
