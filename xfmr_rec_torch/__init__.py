"""PyTorch + CUDA port of the two-tower text recommender (H100 target).

The JAX package `xfmr_rec_tpu` beside this one is the reference: every
module here mirrors its counterpart's layout and semantics, and the
parity tests under `tests/test_torch_*.py` hold the two against each
other on the CPU. This package imports neither `jax` nor anything from
`xfmr_rec_tpu`.

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU; on the CPU every kernel wrapper uses its plain PyTorch version.
Importing the package imports no torch, so `serving/portable.py` (the
numpy-only encoder) runs where torch is not installed.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    if name == "resolve_device":
        from xfmr_rec_torch.device import resolve_device

        return resolve_device
    msg = f"module 'xfmr_rec_torch' has no attribute {name!r}"
    raise AttributeError(msg)
