"""Tensor ops of the port: masks, rotary, token shift, attention, sampling,
losses and the kernel wrappers (flash decode, flash attention, and the
head dims above 256)."""
