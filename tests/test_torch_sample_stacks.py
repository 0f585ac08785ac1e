"""`cli.sample_stacks`: a script run as `__main__` under the stack sampler
keeps its exit code, and its time lands on its own frames."""

import json

from ideal_gan_tpu_torch.cli import sample_stacks


def test_samples_land_on_the_script_frames(tmp_path):
    script = tmp_path / "demo.py"
    script.write_text(
        "import sys, time\n"
        "def slow():\n"
        "    time.sleep(0.4)\n"
        "def main():\n"
        "    slow()\n"
        "    sys.exit(3)\n"
        "main()\n")
    out = tmp_path / "stacks.json"
    rc = sample_stacks.main(["--out", str(out), "--interval", "0.05",
                             "--skip", "1", str(script)])
    assert rc == 3
    got = json.loads(out.read_text())
    inclusive = dict(map(tuple, got["inclusive"]))
    assert inclusive["main > slow"] >= 4
    assert inclusive["main"] >= inclusive["main > slow"]
    assert dict(map(tuple, got["leaf"]))["main | demo.py:slow"] >= 4
