"""Nothing that a run imports is JAX or the JAX package, by whole
top-level names (the port's own name begins with the JAX package's)."""

import subprocess
import sys

from port_bench.harness import forbidden_modules

from .conftest import ROOT


def test_whole_top_level_names():
    assert forbidden_modules({"ideal_gan_tpu_torch.ops": 1,
                              "ideal_gan_tpu_torchx": 1}) == []
    assert forbidden_modules({"ideal_gan_tpu.models": 1, "jax": 1,
                              "jaxlib.xla": 1, "flax.linen": 1}) == [
        "flax.linen", "ideal_gan_tpu.models", "jax", "jaxlib.xla"]


def test_harness_kinds_families_metrics_load_no_jax():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from port_bench.harness import Bench, forbidden_modules
import port_bench.run, port_bench.control
b = Bench(Path({str(ROOT)!r}))
for c in b.spec["configs"]:
    b.family(b.config(c["name"])["family"])
for w in b.spec["workloads"]:
    b.traffic_kind(b.traffic(w["traffic"])["kind"])
for m in b.spec["end_to_end"] + b.spec["per_layer"]:
    b.reader(m["name"])
import ideal_gan_tpu_torch.cli.roi_analysis, ideal_gan_tpu_torch.train.unsup
import ideal_gan_tpu_torch.train.teaug, ideal_gan_tpu_torch.parallel
bad = forbidden_modules()
print(bad)
assert not bad
"""
    subprocess.run([sys.executable, "-c", code], check=True)
