"""The port's public surface against the reference's, module by module.

For every module of ``src/repro/`` the reference's public names are read
from its source with ``ast`` (importing it is not safe here:
``repro.launch.dryrun`` sets ``XLA_FLAGS`` for the whole process, which
the other modules of a pytest worker would inherit).  The names are the
module's public top-level definitions (functions, classes, assigned
names), its ``__all__`` (the package roots build it from tuples of
constants, evaluated here from the AST) and the public methods and
``__call__`` of its public classes.  The port's counterpart module
(``repro/x/y.py`` -> ``repro_torch.x.y``) is imported and every name
checked with ``hasattr``, so a name the port only imports counts; a class's
``__call__`` must be its own or a base's other than ``object``.  Where the
reference has an ``__all__``, each of its entries (or its counterpart) is
also in the port's.

``NO_COUNTERPART`` holds the names that are TPU-only, each with its reason
and, where the port has one, the name that takes its place there; that
name must exist.
"""
import ast
import importlib
import pathlib

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF = SRC / "repro"

# (module of the port, reference name) -> (reason, counterpart or None)
NO_COUNTERPART = {
    ("repro_torch.kernels.ops", "resolve_interpret"): (
        "Pallas interpret mode on a host without a TPU; the port's wrappers "
        "choose the kernel or its plain version by the tensor's device",
        None),
    ("repro_torch.kernels.ops", "vmem_bytes"): (
        "the TPU kernel's VMEM claim; the CUDA kernel's on-chip working set "
        "is its shared memory", "smem_bytes"),
    ("repro_torch.kernels.streamed_matmul", "vmem_bytes"): (
        "the TPU kernel's VMEM claim; the CUDA kernel's on-chip working set "
        "is its shared memory", "smem_bytes"),
    ("repro_torch.kernels.streaming_conv", "DEFAULT_BM"): (
        "the Pallas grid's row block at tile 0; at tile 0 each CUDA kernel "
        "chooses its own (kernels/streaming_conv.py, Tiles)", None),
    ("repro_torch.kernels.streaming_conv", "DEFAULT_BC"): (
        "the Pallas grid's output-channel block at tile 0; at tile 0 "
        "conv2d chooses its own (kernels/streaming_conv.py, Tiles)", None),
    ("repro_torch.core", "TPU_V5E_KERNEL"): (
        "the TPU v5e's kernel-level sheet, re-exported", "H100_KERNEL"),
    ("repro_torch.core", "TPU_V5E_RUNTIME"): (
        "the TPU v5e's runtime sheet, re-exported", "H100_RUNTIME"),
    ("repro_torch.core.resources", "TPU_V5E_KERNEL"): (
        "the TPU v5e's kernel-level sheet (VMEM on chip, HBM off chip)",
        "H100_KERNEL"),
    ("repro_torch.core.resources", "TPU_V5E_RUNTIME"): (
        "the TPU v5e's runtime sheet (HBM on chip, the host link off chip)",
        "H100_RUNTIME"),
    ("repro_torch.core.resources", "PEAK_FLOPS_BF16"): (
        "the TPU v5e's bf16 peak; the H100 sheets rate the card's f32 peak, "
        "the port's parity path", "H100_PEAK_F32_FLOPS"),
    ("repro_torch.core.resources", "HBM_BYTES"): (
        "the TPU v5e's HBM", "H100_HBM_BYTES"),
    ("repro_torch.core.resources", "HBM_GBPS"): (
        "the TPU v5e's HBM bandwidth", "H100_HBM_GBPS"),
    ("repro_torch.core.resources", "VMEM_BYTES"): (
        "the TPU v5e's VMEM; the card's on-chip store is its shared memory",
        "H100_SMEM_PER_SM_BYTES"),
    ("repro_torch.core.resources", "ICI_GBPS_PER_LINK"): (
        "the TPU's inter-chip interconnect; no H100 sheet models the links "
        "between cards", None),
    ("repro_torch.core.resources", "HOST_LINK_GBPS"): (
        "the TPU v5e's host link", "H100_HOST_LINK_GBPS"),
    ("repro_torch.core.resources", "TPU_FREQ_MHZ"): (
        "the TPU v5e's clock", "H100_FREQ_MHZ"),
}


def _modules():
    return sorted(REF.rglob("*.py"))


def _port_module(path: pathlib.Path) -> str:
    parts = list(path.relative_to(SRC).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["repro_torch"] + parts[1:])


def _public(name: str) -> bool:
    return not name.startswith("_")


def _eval(node, env, bound=()):
    """A constant expression; ``dir()`` is the names bound so far (the
    form ``__all__ = [n for n in dir() if ...]``)."""
    scope = {"__builtins__": {"list": list, "tuple": tuple},
             "dir": lambda: sorted(bound)}
    return eval(compile(ast.Expression(node), "<__all__>", "eval"), scope,
                env)


def reference_surface(path: pathlib.Path) -> tuple[set[str], list | None]:
    """(public names, ``__all__`` or None) of one reference module, read
    from its source: a class's methods as ``Class.method``."""
    names: set[str] = set()
    env: dict = {}
    bound: set[str] = set()         # every top-level name bound so far
    exported = None
    for st in ast.parse(path.read_text()).body:
        if isinstance(st, (ast.Import, ast.ImportFrom)):
            bound.update((a.asname or a.name).split(".")[0]
                         for a in st.names)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.add(st.name)
            if _public(st.name):
                names.add(st.name)
        elif isinstance(st, ast.ClassDef):
            bound.add(st.name)
            if _public(st.name):
                names.add(st.name)
                names.update(
                    f"{st.name}.{b.name}" for b in st.body
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and (_public(b.name) or b.name == "__call__"))
        elif isinstance(st, (ast.Assign, ast.AnnAssign)):
            targets = st.targets if isinstance(st, ast.Assign) else [st.target]
            for t in targets:
                if not isinstance(t, ast.Name) or st.value is None:
                    continue
                if t.id == "__all__":
                    exported = list(_eval(st.value, env, bound))
                    names.update(exported)
                    continue
                bound.add(t.id)
                if _public(t.id):
                    names.add(t.id)
                try:        # the constants an __all__ may be built from
                    env[t.id] = _eval(st.value, env)
                except Exception:   # noqa: BLE001 — not a constant
                    pass
    return names, exported


def _has(mod, dotted: str) -> bool:
    obj = mod
    for part in dotted.split("."):
        if part == "__call__" and isinstance(obj, type):
            return any("__call__" in vars(k) for k in obj.__mro__
                       if k is not object)
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def _counterpart(port: str, name: str) -> str | None:
    """The port's name for a reference name: the name itself, or
    NO_COUNTERPART's (None where the port has none)."""
    why = NO_COUNTERPART.get((port, name))
    return name if why is None else why[1]


@pytest.mark.parametrize("path", _modules(),
                         ids=lambda p: str(p.relative_to(REF)))
def test_every_public_name_has_its_counterpart(path):
    port = _port_module(path)
    mod = importlib.import_module(port)
    names, exported = reference_surface(path)
    theirs = {n: _counterpart(port, n) for n in sorted(names)}
    missing = [n for n, c in theirs.items()
               if c is not None and not _has(mod, c)]
    assert not missing, f"{port} lacks the reference's {missing}"
    if exported is not None:
        ours = set(getattr(mod, "__all__", ()))
        not_listed = [n for n in exported
                      if theirs[n] is not None and theirs[n] not in ours]
        assert not not_listed, (f"{port}.__all__ lacks the counterparts of "
                                f"the reference's {not_listed}")


def test_no_counterpart_lists_only_names_the_reference_has():
    """Every entry of NO_COUNTERPART names a module of the port and a
    public name its reference module really has, with a reason."""
    by_port = {_port_module(p): p for p in _modules()}
    for (port, name), (reason, _) in NO_COUNTERPART.items():
        assert reason
        assert port in by_port, port
        names, _ = reference_surface(by_port[port])
        assert name in names, (port, name)
