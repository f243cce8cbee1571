"""The decode kernel's route choice (``kernels.aqua_decode.decode_route``).

A CUDA call takes the group route (bf16: one block per KV head group, TMA
and tensor cores), the float32 group route (the same blocks and copies,
exact float32 on FFMA) or the per-head route, chosen from q̂'s dtype, the
int8 and participating-page flags and the shapes alone; shapes no route
takes raise. Pure Python: runs without a card.
"""
import pytest
import torch

from repro_torch.kernels.aqua_decode import decode_route

BF, F32 = torch.bfloat16, torch.float32


# (dtype, quant, part, D, Dv, route): the served width 128, Danube's 80,
# the widest 256, and 72, a stored AQUA-Memory width (a multiple of 8, not
# of 16); float32 at full precision over every page takes its group route
# at D and Dv multiples of 4 up to D 256, int8 and participating pages the
# per-head route
@pytest.mark.parametrize("dtype,quant,part,d,dv,route", [
    (BF, False, False, 128, 128, "group"),
    (BF, True, False, 128, 128, "group"),
    (BF, False, True, 128, 128, "group"),
    (BF, True, True, 128, 128, "group"),
    (F32, False, False, 128, 128, "group_f32"),
    (F32, True, False, 128, 128, "per_head"),
    (F32, False, True, 128, 128, "per_head"),
    (F32, True, True, 128, 128, "per_head"),
    (BF, True, False, 80, 80, "group"),
    (BF, True, False, 256, 256, "group"),
    (BF, True, False, 32, 32, "group"),
    (BF, False, True, 72, 72, "group"),
    (BF, False, False, 72, 72, "group"),
    (BF, True, True, 80, 80, "group"),
    (BF, True, True, 256, 256, "group"),
    (F32, False, False, 256, 256, "group_f32"),
    (F32, False, False, 4, 4, "group_f32"),
    (F32, False, False, 80, 80, "group_f32"),
    (F32, False, False, 36, 36, "group_f32"),
    (F32, False, False, 96, 128, "group_f32"),
    (F32, False, False, 260, 128, "per_head"),   # D past 256
    (F32, False, False, 30, 30, "per_head"),     # D not a multiple of 4
    (F32, False, False, 128, 102, "per_head"),   # Dv not a multiple of 4
    (F32, True, False, 36, 36, "per_head"),
    (F32, False, True, 256, 256, "per_head"),
])
def test_route_by_dtype_flags_and_shape(dtype, quant, part, d, dv, route):
    assert decode_route(dtype, quant=quant, part=part, d=d, dv=dv,
                        nsel=d * 3 // 4) == route


# widths the group route does not take: the int8 and participating
# variants, and both together, keep the per-head route (every width it took
# before), the full-precision bf16 walk raises as before
@pytest.mark.parametrize("quant,part,d,dv", [
    (True, False, 36, 36),     # D not a multiple of 8
    (True, False, 72, 72),     # int8 rows not whole 16-byte units
    (True, False, 128, 72),
    (True, False, 320, 128),   # D past 256
    (False, True, 36, 36),
    (False, True, 128, 100),   # Dv not a multiple of 8
    (True, True, 72, 72),      # int8 rows not whole 16-byte units
    (True, True, 128, 72),
])
def test_widths_off_the_group_route_take_the_per_head_route(quant, part, d,
                                                             dv):
    assert decode_route(BF, quant=quant, part=part, d=d, dv=dv,
                        nsel=min(d, 256) // 2) == "per_head"


@pytest.mark.parametrize("d,dv", [(36, 36), (128, 100), (320, 128)])
def test_bf16_full_precision_widths_off_the_group_route_raise(d, dv):
    with pytest.raises(ValueError, match="multiples of 8"):
        decode_route(BF, quant=False, part=False, d=d, dv=dv,
                     nsel=min(d, 256) // 2)


@pytest.mark.parametrize("quant,part", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_shapes_neither_route_takes_raise(quant, part):
    for dtype in (BF, F32):
        with pytest.raises(ValueError):
            decode_route(dtype, quant=quant, part=part, d=512, dv=128,
                         nsel=264)
        with pytest.raises(ValueError):
            decode_route(dtype, quant=quant, part=part, d=128, dv=264,
                         nsel=96)
    with pytest.raises(TypeError):
        decode_route(torch.float16, quant=quant, part=part, d=128, dv=128,
                     nsel=96)
