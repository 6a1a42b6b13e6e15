"""dpcorr_torch: the PyTorch/CUDA port of dpcorr for one NVIDIA H100.

The JAX package ``dpcorr`` is the reference; this package imports neither
it nor JAX. Entry points run on the card unless the caller passes
``device="cpu"``; with no card and no device given they raise.

The package exports resolve lazily (PEP 562), so the torch-free parts
(the protocol's transcript auditor, ``python -m dpcorr_torch protocol
scan``) import where torch is not installed.
"""

_EXPORTS = {
    "KERNEL_LAUNCHES": "dpcorr_torch.ops.fused_ni",
    "fused_ni_sums": "dpcorr_torch.ops.fused_ni",
    "ni_sign_fused": "dpcorr_torch.ops.fused_ni",
    "use_fused_ni": "dpcorr_torch.ops.fused_ni",
    "DETAIL_FIELDS": "dpcorr_torch.sim",
    "RepBlockPipeline": "dpcorr_torch.sim",
    "SimConfig": "dpcorr_torch.sim",
    "SimResult": "dpcorr_torch.sim",
    "run_sim_one": "dpcorr_torch.sim",
    "sim_detail_fused": "dpcorr_torch.sim",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
