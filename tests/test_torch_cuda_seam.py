"""The port's one seam to the card (ops/_cuda.py), on the CPU.

Every hand kernel launches through a wrapper of `_cuda`: it takes the
current stream of its tensors' device, calls the C entry, raises a
RuntimeError with the CUDA error string on a failed launch and counts the
launches in `_cuda.LAUNCHES`, one counter keyed by kernel name.  The op
modules call the wrappers and do nothing more, so no other module of
ibgs_tpu_torch/ops looks up a stream, reads an error string or keeps a
counter.  `_cuda.kernel_info` is the one attribute query.
"""
import contextlib
import types
from pathlib import Path

import pytest
import torch

from ibgs_tpu_torch.ops import _cuda
from tests.test_torch_slice import one_torch_thread  # noqa: F401

KERNELS = ("blend_fwd", "blend_bwd", "rgb10_pack", "warp_fwd", "warp_bwd",
           "preprocess_fwd", "preprocess_bwd", "bin_key", "bin_radix",
           "bin_count", "bin_emit", "bin_ranges", "ssim_fwd", "ssim_bwd",
           "optim", "pack_inv", "pack_bwd", "pack_long")
OPS = Path(_cuda.__file__).resolve().parent
# what only the seam may hold
SEAM_WORDS = ("cuda_stream", "current_stream", "error_string", "LAUNCHES")


def test_launches_name_every_kernel():
    assert tuple(_cuda.LAUNCHES) == KERNELS
    assert _cuda.BIN_KERNELS == KERNELS[7:12]
    assert _cuda.PACK_KERNELS == KERNELS[15:]


@pytest.mark.parametrize("path", sorted(p for p in OPS.glob("*.py")
                                        if p.name != "_cuda.py"),
                         ids=lambda p: p.name)
def test_op_modules_launch_only_through_the_seam(path):
    """No op module but _cuda.py names a stream, the error string or a
    launch counter, in code or in docstrings."""
    text = path.read_text()
    assert [w for w in SEAM_WORDS if w in text] == []


@pytest.fixture
def no_card(monkeypatch):
    """A stream of 1234 and a device guard that does nothing, a fresh
    counter, and an error string that needs no build."""
    monkeypatch.setattr(_cuda, "LAUNCHES", dict.fromkeys(_cuda.LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(_cuda, "error_string", lambda err: f"code {err}")
    return monkeypatch


def test_launch_passes_the_stream_counts_and_raises(no_card):
    """The stream goes last; a launch counts only when the entry returns
    0, and a failed one raises with the names of what it launched."""
    seen = []
    _cuda._launch({"bin_key": 1, "bin_radix": 4}, "cpu",
                  lambda *a: seen.append(a) or 0, 7, 8)
    assert seen == [(7, 8, 1234)]
    with pytest.raises(RuntimeError, match=r"^ssim_fwd kernel launch "
                                           r"failed: code 2 \(2\)$"):
        _cuda._launch({"ssim_fwd": 1}, "cpu", lambda *a: 2)
    assert {k: n for k, n in _cuda.LAUNCHES.items() if n} == \
        {"bin_key": 1, "bin_radix": 4}


def test_wrapper_launches_its_entry(no_card):
    """A wrapper hands its C entry the tensors' pointers and the stream and
    counts its kernel."""
    calls = []
    lib = types.SimpleNamespace(
        ibgs_rgb10_pack=lambda *a: calls.append(a) or 0)
    no_card.setattr(_cuda, "load", lambda name: lib)
    images = torch.zeros(2, 3, 5, 3)
    out = torch.zeros(2, 3, 5, 4, dtype=torch.int32)
    _cuda.rgb10_pack(images, out)
    assert calls == [(images.data_ptr(), 2, 3, 5, out.data_ptr(), 1234)]
    assert _cuda.LAUNCHES["rgb10_pack"] == 1


@pytest.mark.parametrize("kernel", list(_cuda._INFO))
def test_kernel_info_reads_its_entry(kernel, no_card):
    """`kernel_info` calls the kernel's own attribute entry with the
    kernel's index and the shape it is built for, and names the fields the
    entry writes; a failed query raises."""
    lib_name, entry, which, fields = _cuda._INFO[kernel]
    shape = {"warp": (4, 5), "preprocess": (9,)}.get(lib_name, ())
    calls = []

    def query(*a):
        calls.append(a[:-1])
        out = a[-1]
        for i in range(len(fields)):
            out[i] = 10 * which + i
        return 0
    no_card.setattr(_cuda, "load",
                    lambda name: types.SimpleNamespace(**{entry: query}))
    got = _cuda.kernel_info(kernel, *shape)
    assert calls == [(which, *shape)]
    assert got == {f: 10 * which + i for i, f in enumerate(fields)}
    assert list(got)[:3] == ["registers", "local_bytes", "ctas_per_sm"]
    no_card.setattr(_cuda, "load", lambda name: types.SimpleNamespace(
        **{entry: lambda *a: 3}))
    with pytest.raises(RuntimeError, match="attribute query failed: code 3"):
        _cuda.kernel_info(kernel, *shape)


def test_kernel_info_covers_the_four_entries():
    """One query for the warp, projection, binning (pack_rows' backward
    among them), SSIM and optimizer kernels, each kernel at its index in
    its entry (the C side's order)."""
    by_entry = {}
    for kernel, (lib, entry, which, _) in _cuda._INFO.items():
        assert entry in _cuda._SIGNATURES and lib in _cuda.SOURCES
        by_entry.setdefault(entry, []).append((which, kernel))
    assert {e: [k for _, k in sorted(v)] for e, v in by_entry.items()} == {
        "ibgs_warp_info": ["warp_fwd", "warp_bwd", "rgb10_pack"],
        "ibgs_preprocess_info": ["preprocess_fwd", "preprocess_bwd"],
        "ibgs_binning_info": [*_cuda.BIN_KERNELS, *_cuda.PACK_KERNELS],
        "ibgs_ssim_info": ["ssim_fwd", "ssim_bwd"],
        "ibgs_optim_info": ["optim"]}
    assert not any(hasattr(_cuda, f"{k}_info")
                   for k in ("warp", "preprocess", "binning", "ssim",
                             "optim"))
