"""The port's config handling, and its independence from JAX.

``btsbot_tpu_torch`` imports torch, numpy and the standard library only: no
jax, no flax, nothing of ``btsbot_tpu`` (whose ``__init__`` loads flax), and
no pandas.  A subprocess import and an AST scan of every module (and of
``chip_smoke.py``) hold it to that.  The optional packages (matplotlib for
the diagnostic figure, wandb, timm, umap; the data layer's and the artifact
path's clients: requests, PIL, astropy, penquins, datasets, huggingface_hub,
onnx, onnxruntime) are imported only inside the functions that use them:
never at a module's top level, and not by importing any module of the port.
"""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from btsbot_tpu.core.config import normalize_config as jax_normalize_config
from btsbot_tpu_torch.core.config import normalize_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "btsbot_tpu", "train_configs", "*.json"))) \
    + [os.path.join(REPO, "btsbot_tpu", "example_data", "train_config.json")]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "btsbot_tpu", "pandas",
             "matplotlib", "sklearn")
# allowed inside a function body only (imported when a figure is drawn, a
# run is logged to wandb, a timm backbone fetched, a UMAP projection made, a
# service queried, a dataset or model published, an ONNX runtime asked)
OPTIONAL = ("matplotlib", "wandb", "timm", "umap", "requests", "PIL", "astropy", "penquins",
            "datasets", "huggingface_hub", "onnx", "onnxruntime")


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_normalize_config_agrees_with_jax(path):
    with open(path) as f:
        raw = json.load(f)
    got, want = normalize_config(raw), jax_normalize_config(raw)
    assert dict(got) == dict(want)
    for prop in ("model_category", "need_triplets", "need_metadata"):
        assert getattr(got, prop) == getattr(want, prop)


@pytest.mark.parametrize("raw", [
    {"model_name": "mm_ConvNeXt", "comb_fc_neurons": 16, "learning_rate": "3e-4",
     "epochs": "7"},
    {"model_name": "ConvNeXt"},
    {"model_name": "mm_MaxViT", "comb_fc1_neurons": 4, "comb_fc_neurons": 16},
])
def test_legacy_repairs_and_defaults_agree_with_jax(raw):
    got, want = normalize_config(raw), jax_normalize_config(raw)
    assert dict(got) == dict(want)
    assert got.model_kind == want.model_kind
    got["metadata_cols"].append("x")  # defaults are not shared between configs
    assert normalize_config(raw)["metadata_cols"] == []


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import btsbot_tpu_torch\n"
        "import btsbot_tpu_torch.engine.serve, btsbot_tpu_torch.models.factory\n"
        "import btsbot_tpu_torch.ops.ln_mlp, btsbot_tpu_torch.ops.convnext_block\n"
        "import btsbot_tpu_torch.ops.preprocess, btsbot_tpu_torch.interop.weights\n"
        "import btsbot_tpu_torch.native, btsbot_tpu_torch.data.synthetic\n"
        "import btsbot_tpu_torch.cli.train, btsbot_tpu_torch.engine.train\n"
        "import btsbot_tpu_torch.metrics.diagnostics, btsbot_tpu_torch.ops.augment\n"
        "import btsbot_tpu_torch.models.maxvit, btsbot_tpu_torch.interop.maxvit_convert\n"
        "import btsbot_tpu_torch.ops.resize, btsbot_tpu_torch.interop.hf\n"
        "import btsbot_tpu_torch.cli.serve, btsbot_tpu_torch.cli.val\n"
        "import btsbot_tpu_torch.data.avro, btsbot_tpu_torch.data.kafka\n"
        "import btsbot_tpu_torch.metrics.calibration\n"
        "import btsbot_tpu_torch.models.init, btsbot_tpu_torch.utils.logging\n"
        "import btsbot_tpu_torch.metrics.embeddings, btsbot_tpu_torch.interop.manifests\n"
        "import btsbot_tpu_torch.interop.pretrained, btsbot_tpu_torch.engine.distill\n"
        "import btsbot_tpu_torch.cli.distill, btsbot_tpu_torch.cli.sweep\n"
        "import btsbot_tpu_torch.utils.profiling, btsbot_tpu_torch.utils.compile_cache\n"
        "import btsbot_tpu_torch.data.alerts, btsbot_tpu_torch.data.splits\n"
        "import btsbot_tpu_torch.data.hf_dataset, btsbot_tpu_torch.data.query.kowalski\n"
        "import btsbot_tpu_torch.data.query.ztfid, btsbot_tpu_torch.data.query.cutouts\n"
        "import btsbot_tpu_torch.cli.dataset, btsbot_tpu_torch.cli.download\n"
        "import btsbot_tpu_torch.interop.onnx_proto, btsbot_tpu_torch.interop.onnx_numpy\n"
        "import btsbot_tpu_torch.interop.onnx_export, btsbot_tpu_torch.cli.export\n"
        "import btsbot_tpu_torch.interop.publish, btsbot_tpu_torch.cli.publish\n"
        "import btsbot_tpu_torch.parallel.mesh, btsbot_tpu_torch.parallel.sharding\n"
        "import btsbot_tpu_torch.parallel.multihost_check, btsbot_tpu_torch.parallel.dryrun\n"
        "btsbot_tpu_torch.AlertScorer, btsbot_tpu_torch.build_model\n"
        "btsbot_tpu_torch.AlertStreamConsumer\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + OPTIONAL!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _names(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module]
    return []


def _imports(path, top_level_only=False):
    """Absolute imports of a file: anywhere in it, or only those outside
    every function body."""
    tree = ast.parse(open(path).read(), filename=path)
    if not top_level_only:
        for node in ast.walk(tree):
            yield from _names(node)
        return
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield from _names(node)
        stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "btsbot_tpu_torch", "**", "*.py"), recursive=True))
    + [os.path.join(REPO, "chip_smoke.py")], ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_anywhere_in_the_port(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN
           and m.split(".")[0] not in OPTIONAL]
    assert not bad, f"{path} imports {bad}"
    eager = [m for m in _imports(path, top_level_only=True)
             if m.split(".")[0] in OPTIONAL]
    assert not eager, f"{path} imports {eager} outside a function"
