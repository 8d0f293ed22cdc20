"""The whole-name import check."""

import subprocess
import sys

from ctrbench.harness import imports, spec


def test_whole_top_level_names():
    assert imports.forbidden_in(["jax", "numpy"]) == ["jax"]
    assert imports.forbidden_in(["jax.numpy", "jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
    assert imports.forbidden_in(["distributed_tf_serving_tpu.models"]) == [
        "distributed_tf_serving_tpu"]
    assert imports.forbidden_in(["distributed_tf_serving_tpu_torch",
                                 "distributed_tf_serving_tpu_torch.serving.server",
                                 "jaxtyping", "flaxen"]) == []


def test_the_harness_and_the_port_load_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import ctrbench.harness.runner, ctrbench.harness.replica, ctrbench.calibrate\n"
            "import distributed_tf_serving_tpu_torch.serving.server\n"
            "from ctrbench.harness import imports\n"
            "print(imports.forbidden_loaded())\n") % str(spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=spec.ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"
