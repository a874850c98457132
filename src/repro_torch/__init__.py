"""SMOF on PyTorch and CUDA — the port of the ``repro`` package to an
NVIDIA H100.

It keeps its own copy of the JAX-free graph/DSE core (``repro_torch.core``)
and imports neither ``jax`` nor ``repro``.  The public surface is the
compile façade:

    import repro_torch

    compiled = repro_torch.compile(repro_torch.CompileSpec(
        model="unet_exec", device="u200", mode="staged"))
    y = compiled(x)                   # the same as compiled.run(x)

The façade names below resolve lazily (PEP 562), so ``import
repro_torch.core`` does not load the executor.
"""

_API_NAMES = ("CompileSpec", "Compiled", "compile", "build_plan",
              "add_compile_args", "spec_from_args", "MODES", "STRATEGIES")

# telemetry surface (repro_torch.obs), same lazy resolution
_OBS_NAMES = ("ObsConfig", "TraceRecorder", "NullRecorder", "ModelCheck",
              "ContentionCheck", "LatencyHistogram", "validate_chrome_trace",
              "MetricsRegistry", "parse_metrics_text",
              "SloConfig", "SloEvaluator", "FlightRecorder")

# off-chip channel surface (repro_torch.memory), same lazy resolution
_MEMORY_NAMES = ("ChannelConfig", "MemoryModel")

__all__ = list(_API_NAMES) + list(_OBS_NAMES) + list(_MEMORY_NAMES)


def __getattr__(name):
    if name in _API_NAMES:
        from . import api
        return getattr(api, name)
    if name in _OBS_NAMES:
        from . import obs
        return getattr(obs, name)
    if name in _MEMORY_NAMES:
        from . import memory
        return getattr(memory, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_API_NAMES) | set(_OBS_NAMES)
                  | set(_MEMORY_NAMES))
