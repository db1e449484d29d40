"""The main path needs none of flax, msgpack or PyYAML: with all three
blocked from import, a tiny train step and a golden decode still run."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = """
import sys
for name in ("flax", "msgpack", "yaml"):
    sys.modules[name] = None  # any import of them now raises ImportError
sys.path.insert(0, {repo!r})
"""

TRAIN = """
from gluon_e2e_asr import train
train.main(["--config", "tests/goldens/tiny_golden.yaml",
            "--workdir", {wd!r}, "--max-steps", "1",
            "--set", "data.synth_num_train=8",
            "--set", "data.synth_num_dev=8"])
"""

DECODE = """
from gluon_e2e_asr import decode
res = decode.main(["--config", "tests/goldens/tiny_golden.yaml",
                   "--ckpt", "tests/goldens/tiny_golden.msgpack",
                   "--method", "beam", "--max-utts", "4",
                   "--output", {wd!r} + "/beam.jsonl"])
assert res["num_utts"] == 4, res
"""

CHECK = """
loaded = sorted(m for m in ("flax", "msgpack", "yaml")
                if sys.modules.get(m) is not None)
assert not loaded, loaded
print("FLAX_FREE_OK")
"""


@pytest.mark.parametrize("job", ["train", "decode"])
def test_main_path_runs_without_flax_msgpack_yaml(job, tmp_path):
    body = {"train": TRAIN, "decode": DECODE}[job]
    code = (BLOCK.format(repo=REPO) + body.format(wd=str(tmp_path))
            + CHECK)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_COMPILATION_CACHE="false")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FLAX_FREE_OK" in r.stdout
