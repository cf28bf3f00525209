"""What the port's test files (tests/test_torch_*.py) share.

- One torch thread a process. The suite runs several xdist workers (and
  worlds of rank processes) on the machine's cores at once; with torch's
  default of a thread a core, a small op's threads spin on each other
  (a [3, 5, 64] log_softmax took 5 ms instead of 3 us under load).
- `port_jax_compile_cache`, an autouse fixture each of those files
  imports: while a port test module runs, JAX compiles through a
  persistent compilation cache that the run's workers share, so a JAX
  reference that several port tests build (the same program at the same
  shapes) compiles once. The JAX package's own test modules run without
  it, as before. A cached executable is the same executable: results do
  not change.
"""

import os

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def port_jax_compile_cache(tmp_path_factory):
    import jax
    from jax._src import compilation_cache

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent          # the session's, above each worker's
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    jax.config.update(names[0], str(base / "port_jax_compile_cache"))
    jax.config.update(names[1], 0.0)
    compilation_cache.reset_cache()     # (re)read the settings above
    yield
    for n, v in saved.items():
        jax.config.update(n, v)
    compilation_cache.reset_cache()
