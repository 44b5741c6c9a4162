"""Tensor ops of the port: masks, rotary, token shift, attention, sampling
and the flash-decode kernel wrapper."""
