"""Shared pytest setup: one JAX compatibility shim and the ``cuda`` marker.

``repro.core.marker`` builds its check-sink primitive with
``jax.core.Primitive``.  Newer JAX releases moved that class to
``jax.extend.core``; restoring the old attribute here, before any test
module is collected, lets every xdist worker import the reference package
whichever test file it is handed first.
"""
import jax
import jax.extend.core

if not hasattr(jax.core, "Primitive"):
    jax.core.Primitive = jax.extend.core.Primitive


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: launches a hand-written CUDA kernel; needs an NVIDIA GPU and "
        "nvcc, and skips where torch.cuda.is_available() is false")
