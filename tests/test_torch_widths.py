"""Every ConvNeXt width reaches a hand-written kernel (CPU, no build).

The kernel wrappers used to take C in {64, 128, 256, 512} only, so on the
card every ConvNeXt and InceptionNeXt size but pico raised.  Held here in
pure Python, with the kernel library replaced by a recorder and the input
standing in for a CUDA tensor: both wrappers accept every C of
``CONVNEXT_CONFIGS`` at every hidden width k·C an ``.r<k>`` kind can ask
for, and send it by width and type: float32 at every width to the
three-TF32-product tensor-core kernels of ``csrc/tf32x3.cu`` ("tf32x3",
with a workspace for the split weights), bfloat16 to the tuned kernels (C =
64, 128, 256, 512) or at every other width to the padded tensor-core
kernels ("wgmma_any"), counting each launch by variant and width.  The kernels' arithmetic is held on the card by ``chip_smoke.py``
(phase "widths").  Beside that: the plain path's f32 logits of mm_ConvNeXt
at the femto and nano widths against flax on the same weights, within
atol 1e-5.
"""

import numpy as np
import pytest
import torch

from btsbot_tpu_torch.models.convnext import CONVNEXT_CONFIGS
from btsbot_tpu_torch.ops import _build
from btsbot_tpu_torch.ops import convnext_block as port_block
from btsbot_tpu_torch.ops import ln_mlp as port_mlp
from test_torch_model import atto_config, flax_logits, flax_variables, port_model

WIDTHS = sorted({c for spec in CONVNEXT_CONFIGS.values() for c in spec["dims"]})
RATIOS = (1, 2, 3, 4, 8)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is a CUDA one: it passes the wrappers'
    device check and reaches the launch."""
    is_cuda = property(lambda self: True)


class _Recorder:
    """Stands in for the kernel library: each entry point records its
    (name, C, hidden) and reports success; the float32 kernels' workspace
    query answers one float."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("btsbot_"):
            raise AttributeError(name)
        if name == "btsbot_tf32x3_workspace_floats":  # a size query, not a launch
            return lambda m, c, hidden, taps: 1

        def entry(*args):
            # ..., C, hidden, [LN eps: the LN -> MLP entry points,] [is_bf16: the
            # bf16 entry points,] stream
            end = -1 - ("ln_mlp" in name) - (not name.endswith("_tf32x3"))
            c, hidden = args[end - 2:end]
            self.calls.append((name, c, hidden))
            return 0
        return entry


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "current_stream", lambda x: 0)
    for fn in (port_block.convnext_block_fused, port_mlp.fused_ln_mlp):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_width", {}, raising=False)
    return rec


def _block_args(c, hidden, dtype):
    x = torch.zeros(2, 3, 3, c, dtype=dtype).as_subclass(_OnCard)
    return [x, torch.zeros(c, 1, 7, 7), torch.zeros(c), torch.ones(c), torch.zeros(c),
            torch.zeros(hidden, c), torch.zeros(hidden), torch.zeros(c, hidden),
            torch.zeros(c), torch.zeros(c)]


def test_widths_are_the_model_kinds_widths():
    assert WIDTHS == [40, 48, 64, 80, 96, 128, 160, 192, 256, 320, 384, 512, 640,
                      768, 1024]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("c", WIDTHS)
def test_both_wrappers_launch_every_width(c, dtype, recorder):
    for k in RATIOS:
        hidden = k * c
        args = _block_args(c, hidden, dtype)
        out = port_block._FusedBlock.apply(*args)
        assert out.shape == args[0].shape and out.dtype == dtype
        rows = args[0].reshape(-1, c)
        out = port_mlp._FusedLnMlp.apply(rows, rows, *args[3:])
        assert out.shape == rows.shape
    variant = _build.kernel_variant(c, 4 * c, dtype)
    suffix = {"tuned": "", "tf32x3": "_tf32x3", "wgmma_any": "_wgmma"}[variant]
    assert variant == ("tf32x3" if dtype == torch.float32
                       else "tuned" if c in _build.TUNED_WIDTHS else "wgmma_any")
    want = []
    for k in RATIOS:
        want += [(f"btsbot_convnext_block{suffix}", c, k * c),
                 (f"btsbot_ln_mlp{suffix}", c, k * c)]
    assert recorder.calls == want
    for fn in (port_block.convnext_block_fused, port_mlp.fused_ln_mlp):
        assert fn.launches == len(RATIOS)
        assert fn.launches_by_width == {(variant, c, k * c): 1 for k in RATIOS}


def test_kernel_variant_by_width():
    assert [_build.kernel_variant(c, 4 * c, torch.float32) for c in WIDTHS] == [
        "tf32x3"] * len(WIDTHS)
    assert [_build.kernel_variant(c, 4 * c, torch.bfloat16) for c in WIDTHS] == [
        "tuned" if c in (64, 128, 256, 512) else "wgmma_any" for c in WIDTHS]
    for dtype, tuned, other in ((torch.float32, "tf32x3", "tf32x3"),
                                (torch.bfloat16, "tuned", "wgmma_any")):
        assert _build.kernel_variant(64, 64 * 3, dtype) == tuned
        assert _build.kernel_variant(128, 200, dtype) == other  # hidden not in 64-units
        for c, hidden in ((36, 144), (40, 0), (0, 64), (64, 100)):
            with pytest.raises(ValueError, match="multiples of 8"):
                _build.kernel_variant(c, hidden, dtype)
    # nothing takes either type past 1024 channels, or another type
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="up to 1024"):
            _build.kernel_variant(1032, 4 * 1032, dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _build.kernel_variant(64, 256, torch.float16)


@pytest.mark.parametrize("size", ["femto", "nano"])
def test_f32_plain_path_logits_match_flax(size):
    config = atto_config(kind=f"convnext_{size}.d1_in1k")
    variables = flax_variables(config, seed=3)
    rng = np.random.default_rng(4)
    img = rng.normal(size=(3, 63, 63, 3)).astype(np.float32)
    img /= np.sqrt((img ** 2).sum(axis=(1, 2), keepdims=True))
    meta = rng.normal(size=(3, 25)).astype(np.float32)
    want = flax_logits(config, variables, img, meta)
    with torch.no_grad():
        got = port_model(config, variables)(torch.from_numpy(img),
                                            torch.from_numpy(meta)).numpy().reshape(-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
