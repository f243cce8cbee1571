"""The port's kernel build and launch guards that need no card: the
library tag covers the shared headers, and the bf16 kernels' 16-byte copy
guard accepts aligned views and refuses misaligned ones (ValueError)."""
import pytest
import torch

from repro_torch.kernels import _build


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
