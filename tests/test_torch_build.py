"""The port's kernel build and launch guards that need no card: the
library tag covers the shared headers, the bf16 kernels' 16-byte copy
guard accepts aligned views and refuses misaligned ones (ValueError), and
their TMA tensor-map guard refuses strides of 2**40 bytes or more and axes
of 2**32 elements or more (ValueError). The float32 kernels' copy width
(16-byte copies where the views, dim-blocks and widths allow, else 4-byte
ones) and the widest union of selected dims a 64-row float32 prefill
block gathers."""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import aqua_prefill as pk


def _tag(monkeypatch, tmp_path, cu: str, cuh: str) -> str:
    (tmp_path / "k.cu").write_text(cu)
    (tmp_path / "tile.cuh").write_text(cuh)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return _build._lib_path("k").name


def test_lib_path_changes_with_source_and_header(monkeypatch, tmp_path):
    base = _tag(monkeypatch, tmp_path, "int a;", "int b;")
    assert base == _tag(monkeypatch, tmp_path, "int a;", "int b;")
    assert base != _tag(monkeypatch, tmp_path, "int a;", "int c;")
    assert base != _tag(monkeypatch, tmp_path, "int z;", "int b;")
    assert base.startswith("libk-") and base.endswith(".so")


def _aligned(*shape, dtype=torch.bfloat16):
    # a base on a 64-byte boundary, whatever the allocator returned
    flat = torch.zeros(int(torch.tensor(shape).prod()) + 32, dtype=dtype)
    skip = (-flat.data_ptr() % 64) // flat.element_size()
    return flat[skip:skip + int(torch.tensor(shape).prod())].view(*shape)


@pytest.mark.parametrize("make", [
    lambda: _aligned(2, 4, 16, 64),                              # contiguous
    lambda: _aligned(2, 16, 4, 64).transpose(1, 2),              # (B,S,H,D) view
    lambda: _aligned(2, 4, 16, 64)[:, :, 8:],                    # row slice
    lambda: _aligned(1, 4, 16, 64).expand(1, 4, 16, 64),
    lambda: _aligned(2, 4, 16, 64, dtype=torch.float32)[..., 4:8],
])
def test_cp_async_guard_accepts_aligned_views(make):
    _build.check_cp_async("k", make())


@pytest.mark.parametrize("make", [
    lambda: _aligned(4 * 16 * 64 + 4).narrow(0, 4, 4 * 16 * 64).view(
        1, 4, 16, 64),                                           # base + 4
    lambda: _aligned(2, 4, 16, 68)[..., 4:],                     # base, stride
    lambda: _aligned(2, 4, 16, 68)[..., :64],                    # row stride 68
    lambda: _aligned(2, 4, 16, 64, dtype=torch.float32)[..., 2:6],
])
def test_cp_async_guard_refuses_misaligned_views(make):
    with pytest.raises(ValueError, match="16-byte aligned"):
        _build.check_cp_async("k", make())


class _View:
    """A tensor's shape, strides and element size, without its storage
    (the sizes the TMA guard refuses do not fit in memory)."""

    def __init__(self, shape, stride, size=2):
        self.shape, self._stride, self._size = shape, stride, size

    def stride(self):
        return self._stride

    def element_size(self):
        return self._size


@pytest.mark.parametrize("make", [
    lambda: _aligned(2, 4, 16, 64),                              # contiguous
    lambda: _aligned(2, 16, 4, 64).transpose(1, 2),              # (B,S,H,D) view
    # a stride of 2**40 bytes on an axis of size 1 is never used
    lambda: _View((1, 8, 4096, 128), (2 ** 39, 128, 1024, 1)),
    # the largest stride it takes: 2**40 - 16 bytes
    lambda: _View((2, 8, 4096, 128), (2 ** 39 - 8, 128, 1024, 1)),
])
def test_tma_guard_accepts(make):
    _build.check_tma("k", make())


@pytest.mark.parametrize("make", [
    lambda: _View((2, 8, 4096, 128), (2 ** 39, 128, 1024, 1)),  # 2**40 bytes
    lambda: _View((1, 8, 4096, 128), (2 ** 42, 2 ** 38, 1024, 1), size=4),
    lambda: _View((1, 1, 2 ** 32, 8), (2 ** 35, 2 ** 35, 8, 1)),  # 2**32 keys
])
def test_tma_guard_refuses(make):
    with pytest.raises(ValueError, match="2\\*\\*40 bytes"):
        _build.check_tma("k", make())


@pytest.mark.parametrize("make,block_dims,width", [
    (lambda: _aligned(2, 4, 16, 64, dtype=torch.float32), 8, 4),
    (lambda: _aligned(2, 16, 4, 64, dtype=torch.float32).transpose(1, 2),
     4, 4),                                                 # (B,S,H,D) view
    (lambda: _aligned(2, 4, 16, 64, dtype=torch.float32), 2, 1),  # blocks of 2
    (lambda: _aligned(2, 4, 16, 68, dtype=torch.float32)[..., 2:66], 8, 1),
    (lambda: _aligned(2, 4, 16, 66, dtype=torch.float32)[..., :64], 8, 1),
    (lambda: _aligned(2, 4, 16, 72, dtype=torch.float32)[..., :70], 2, 1),
])
def test_f32_copy_width(make, block_dims, width):
    """4 floats (16 bytes) a copy only where the base, every outer stride,
    the dim-blocks and the last axis are whole 16-byte units."""
    x = make()
    assert _build.f32_copy_width(x, x, x, block_dims=block_dims) == width


@pytest.mark.parametrize("d,nsel,q_blk,nqc,width", [
    (128, 96, 128, 8, 96),      # one q-tile a block: its own selection
    (128, 96, 256, 4, 96),
    (128, 96, 64, 16, 96),
    (128, 96, 32, 32, 128),     # two tiles a block, capped at D
    (64, 24, 24, 9, 64),        # up to four tiles straddle a block
    (512, 64, 72, 8, 128),      # 72 rows: two tiles
    (512, 128, 8, 64, 512),     # eight tiles: past the 256 gathered dims
    (128, 96, 16, 1, 96),       # one tile in all
])
def test_f32_union_width(d, nsel, q_blk, nqc, width):
    assert pk._f32_union_width(d, nsel, q_blk, nqc) == width
