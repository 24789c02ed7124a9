"""Where the persistent compile cache goes: JAX_COMPILATION_CACHE_DIR when
it is set (the package then sets no directory itself), otherwise one fixed
directory inside the checkout.  Each case runs in a fresh interpreter."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, jax, jax.numpy as jnp
import jn_cuclark_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + 11)(jnp.arange(7)).block_until_ready()
print(json.dumps({"dir": jax.config.jax_compilation_cache_dir,
                  "default": jn_cuclark_tpu.DEFAULT_COMPILE_CACHE}))
"""


def _probe(tmp_path, cache_dir=None):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               HOME=str(tmp_path), TMPDIR=str(tmp_path))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if cache_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(cache_dir)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_env_cache_dir_is_honoured(tmp_path):
    cache = tmp_path / "outside_cache"
    got = _probe(tmp_path, cache)
    assert got["dir"] == str(cache)
    assert cache.is_dir() and any(cache.iterdir())  # entries written there


def test_default_cache_dir_is_fixed_in_checkout(tmp_path):
    # two processes with different cwd, HOME and TMPDIR agree on the path
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a = _probe(tmp_path / "a")
    b = _probe(tmp_path / "b")
    want = os.path.join(REPO, ".jax_cache")
    assert a["dir"] == b["dir"] == a["default"] == want
    assert os.path.isdir(want) and os.listdir(want)
