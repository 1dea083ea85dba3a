"""Import hygiene of the PyTorch port: no module of the port package and not
``chip_smoke.py`` imports JAX, flax, msgpack or the JAX package."""

import ast
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(ROOT, "gymothelloenv_tpu_torch")
FORBIDDEN = {"jax", "flax", "msgpack", "gymothelloenv_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    bad = sorted(set(_top_level_imports(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_forbidden_match_is_exact():
    """``gymothelloenv_tpu_torch`` shares the JAX package's prefix and
    must not be caught by the rule."""
    names = set()
    for path in _port_files():
        names |= set(_top_level_imports(path))
    assert "gymothelloenv_tpu_torch" in names
    assert "gymothelloenv_tpu" not in names


def test_training_slice_modules_are_checked():
    """The K3 path, the PPO training path, checkpoint IO, maximin and the
    evaluation CLIs are among the files above."""
    checked = {os.path.relpath(p, PORT) for p in _port_files()}
    for rel in ("agents/ppo.py", "ops/shuffle.py", "ops/rollout.py",
                "train/self_play.py", "train/ppo_trainer.py",
                "utils/logging.py", "cli/ppo_self_play.py",
                "scripts/bench_rollout_variants.py", "utils/checkpoint.py",
                "models/convert.py", "policies/scripted.py",
                "cli/tournament.py", "cli/eval_checkpoint.py",
                "scripts/ladder.py", "envs/vec_wrappers.py"):
        assert rel in checked, rel


_SLICE_10 = ("agents/rainbow.py", "train/rainbow_trainer.py",
             "cli/rainbow_train.py", "agents/a2c.py", "train/a2c_trainer.py",
             "cli/a2c_train.py", "agents/kfac.py", "train/acktr_trainer.py",
             "cli/acktr_train.py")


@pytest.mark.parametrize("rel", _SLICE_10)
def test_rainbow_a2c_acktr_modules_are_checked_and_import(rel):
    """Rainbow's, A2C's and ACKTR's modules are among the files above and
    import without a card (no kernel is built at import)."""
    import importlib
    assert rel in {os.path.relpath(p, PORT) for p in _port_files()}
    module = "gymothelloenv_tpu_torch." + rel[:-3].replace("/", ".")
    importlib.import_module(module)


_SLICE_11 = ("agents/simple_ppo.py", "train/simple_ppo_trainer.py",
             "cli/run_self_play.py", "agents/gail.py",
             "train/gail_trainer.py", "cli/gail_train.py",
             "scripts/make_expert_dataset.py", "compat/__init__.py",
             "compat/featurize.py", "compat/envs.py", "compat/policies.py",
             "compat/torch_import.py", "compat/agents.py", "cli/run.py",
             "cli/run_2agent.py")


@pytest.mark.parametrize("rel", _SLICE_11)
def test_simple_ppo_gail_compat_modules_are_checked_and_import(rel):
    """Simple PPO's, GAIL's and the compat layer's modules are among the
    files above and import without a card (no kernel is built at
    import)."""
    import importlib
    assert rel in {os.path.relpath(p, PORT) for p in _port_files()}
    module = "gymothelloenv_tpu_torch." + rel[:-3].replace("/", ".")
    importlib.import_module(module.removesuffix(".__init__"))
