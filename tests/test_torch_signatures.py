"""The port's public signatures against the JAX package's.

For every module the two packages share, every public function and every
public method of a public class that both define: JAX's parameter names,
in JAX's order, are the leading parameters of the port's (port-only
parameters such as ``ops``, ``device`` or ``variant`` come after them),
and where JAX gives a plain default (a number, a string, a bool or None)
the port gives the same one.  A caller written against JAX that passes
arguments by position then binds every one of them to the same
parameter.  One exemption, :data:`EXEMPT`.

Also the row-major filter path's names (``sosfilt_scan``,
``sosfilt_blocked``, ``sosfilt``, ``sosfilt_blocked_multi``,
``sosfilt_blocked_multi_rows``, ``apply_eq``) exist in the port, and the
JAX switches the port takes only in one setting (``kernel``,
``channel_major``) raise for any other, naming it.
"""

import importlib
import inspect
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = "python_audio_mastering_tpu"
PORT_PKG = "python_audio_mastering_tpu_torch"
# sosfilt_sharded runs under JAX's shard_map, naming its mesh axis; the
# port's runs over the ranks of a parallel.mesh mesh, which it must be
# given with the axis name: (mesh, axis) where JAX has (axis_name,)
EXEMPT = {"ops.iir.sosfilt_sharded"}
_PLAIN = (bool, int, float, str, type(None))


def _shared_modules():
    """Module names (relative, dotted) present in both packages."""
    out = []
    for path in sorted((ROOT / JAX_PKG).rglob("*.py")):
        rel = path.relative_to(ROOT / JAX_PKG).with_suffix("")
        if rel.name == "__main__" or not (ROOT / PORT_PKG / path.relative_to(
                ROOT / JAX_PKG)).exists():
            continue
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


MODULES = _shared_modules()


def _public(mod):
    """``{qualified name: callable}`` of the public functions defined in
    ``mod`` and the public methods of its public classes."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != \
                mod.__name__:
            continue
        if inspect.isfunction(obj):
            out[name] = obj
        elif inspect.isclass(obj):
            for m, fn in vars(obj).items():
                fn = fn.__func__ if isinstance(fn, (classmethod,
                                                    staticmethod)) else fn
                if not m.startswith("_") and inspect.isfunction(fn):
                    out[f"{name}.{m}"] = fn
    return out


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


@pytest.mark.parametrize("sub", MODULES, ids=lambda s: s or "__init__")
def test_port_signatures_lead_with_jax_parameters(sub):
    """JAX's parameters, names, order and plain defaults, lead the port's
    for every function and method both packages define here."""
    suffix = f".{sub}" if sub else ""
    jmod = importlib.import_module(JAX_PKG + suffix)
    pmod = importlib.import_module(PORT_PKG + suffix)
    pfns = _public(pmod)
    bad = []
    for name, jfn in _public(jmod).items():
        if name not in pfns or f"{sub}.{name}".lstrip(".") in EXEMPT:
            continue
        jp, pp = _params(jfn), _params(pfns[name])
        if [p.name for p in pp[:len(jp)]] != [p.name for p in jp]:
            bad.append(f"{name}: JAX {[p.name for p in jp]}, port "
                       f"{[p.name for p in pp]}")
            continue
        for j, p in zip(jp, pp):
            if (j.default is not inspect.Parameter.empty
                    and isinstance(j.default, _PLAIN)
                    and p.default != j.default):
                bad.append(f"{name}: {j.name} defaults to {j.default!r} in "
                           f"JAX, {p.default!r} in the port")
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("qual", [
    "ops.iir.sosfilt_scan", "ops.iir.sosfilt_blocked", "ops.iir.sosfilt",
    "ops.iir.sosfilt_blocked_multi", "ops.iir.sosfilt_blocked_multi_rows",
    "models.chain.apply_eq"])
def test_row_major_filter_names_exist(qual):
    """The JAX package's row-major filter path is in the port, JAX's
    parameters leading."""
    mod, name = qual.rsplit(".", 1)
    jfn = getattr(importlib.import_module(f"{JAX_PKG}.{mod}"), name)
    pfn = getattr(importlib.import_module(f"{PORT_PKG}.{mod}"), name)
    want = [p.name for p in _params(jfn)]
    assert [p.name for p in _params(pfn)][:len(want)] == want


def test_jax_switches_raise_naming_the_value():
    """``kernel`` other than "auto" and ``channel_major=True`` raise a
    ValueError that names them; the defaults run."""
    from python_audio_mastering_tpu_torch.ops import loudness, multiband

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, 384)).astype(np.float32))
    with pytest.raises(ValueError, match="'pallas'"):
        loudness.block_cell_energies_rows(x, 44100, kernel="pallas")
    with pytest.raises(ValueError, match="'xla'"):
        multiband.multiband_compress_rows(x, 44100, (-20.0,) * 3, (4.0,) * 3,
                                          kernel="xla")
    audio = x.reshape(-1, 1)
    with pytest.raises(ValueError, match="channel_major"):
        loudness.normalize_to_lufs(audio, 44100, channel_major=True)
    with pytest.raises(ValueError, match="channel_major"):
        multiband.multiband_compress(audio, 44100, (-20.0,) * 3, (4.0,) * 3,
                                     channel_major=True)
    y, _, _ = loudness.normalize_to_lufs(audio, 44100, -14.0,
                                         "reference_mono_mean", "blocked")
    assert y.shape == audio.shape
