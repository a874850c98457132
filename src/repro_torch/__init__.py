"""SMOF on PyTorch and CUDA — the port of the ``repro`` package to an
NVIDIA H100.

It keeps its own copy of the JAX-free graph/DSE core (``repro_torch.core``)
and imports neither ``jax`` nor ``repro``.  The public surface is the
compile façade:

    import repro_torch

    compiled = repro_torch.compile(repro_torch.CompileSpec(
        model="unet_exec", device="u200", mode="staged"))
    y = compiled.run(x)

The façade names resolve lazily (PEP 562), so ``import repro_torch.core``
does not load the executor.
"""

_API_NAMES = ("CompileSpec", "Compiled", "compile", "build_plan", "MODES",
              "STRATEGIES")

__all__ = list(_API_NAMES)


def __getattr__(name):
    if name in _API_NAMES:
        from . import api
        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_API_NAMES))
