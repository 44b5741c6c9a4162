"""Serving observability: request tracing (`tracing.py`), structured logs
(`logging.py`), trace-context headers (`aggregate.py`) and worker stacks
(`vitals.py`), counterparts of the JAX package's `obs/` modules of those
names (the parts the HTTP server uses)."""
