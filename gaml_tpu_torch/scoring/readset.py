"""Adopt a prepared gaml_tpu ReadSet into the port.

The read set keeps its index, read cache and native bundle; its aligner
becomes a TorchSubpathAligner on the given device, and the warm-up router
of the JAX route (ReadSet._device_ready, which hid XLA compiles) always
answers "ready".  GAML_DEV_MIN_BASES keeps its meaning: miss batches
below that many window bases go to the native aligner.
"""
from __future__ import annotations

from gaml_tpu.scoring.readset import ReadSet

from ..align.aligner import TorchSubpathAligner


class TorchReadSet(ReadSet):
    """A ReadSet whose device batches run on the port."""

    def _device_ready(self, graph, subpaths) -> bool:
        return True


def adopt_readset(rs: ReadSet, device) -> TorchReadSet:
    """Swap in the port's aligner (same index, read cache and native
    bundle) on ``rs``, which must be built with backend="device" and
    prepared (prepare_read_index).  Returns ``rs`` itself."""
    if rs.backend != "device":
        raise ValueError(f"read set {rs.name}: backend must be 'device', "
                         f"got {rs.backend!r}")
    old = rs.aligner
    if old is None:
        raise ValueError(f"read set {rs.name}: call prepare_read_index "
                         "before adopting it")
    al = TorchSubpathAligner(old.index, old.read_seqs, device=device)
    al._read_cache = old._read_cache
    bundle = getattr(old, "native_bundle", None)
    if bundle is not None:
        al.native_bundle = bundle
    rs.aligner = al
    rs.__class__ = TorchReadSet
    return rs
