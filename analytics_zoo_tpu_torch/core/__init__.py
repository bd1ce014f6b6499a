"""Core runtime of the port: configuration and the serving stack's
telemetry (metrics registry, request tracing, fault injection, flight
recorder), each a copy of the JAX package's module of the same name.

The submodules are imported by name (``from analytics_zoo_tpu_torch.core
import metrics``); importing this package loads none of them.
"""
