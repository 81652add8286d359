"""Guards on the port package's boundaries (CPU, no JAX needed).

  * hello_tpu_torch imports neither jax nor any module of hello_tpu;
  * the host modules it copies stay byte-identical to hello_tpu's, so
    hello_tpu's fuzz and parity suites keep pinning what the port runs;
  * entry points default to CUDA and raise without a card;
  * what this slice does not port raises, naming the ROADMAP item.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "hello_tpu_torch")

# modules the port copies byte for byte from hello_tpu
COPIED = [
    "constants.py", "reads.py", "cigar.py",
    "io/__init__.py", "io/fasta.py", "io/bam.py", "io/vcf.py",
    "counts.py", "assembly.py", "featurize.py", "window.py", "native.py",
    "pipeline/__init__.py", "pipeline/hotspots.py", "pipeline/candidates.py",
    "pipeline/batching.py", "sim.py", "nn/archs.py",
]

_IMPORT = re.compile(
    r"^\s*(import\s+(jax|hello_tpu)\b(?!_torch)|from\s+(jax|hello_tpu)\b(?!_torch))",
    re.M)
_NAME = re.compile(r"hello_tpu\.")


def _port_files():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith((".py", ".cu")):
                path = os.path.join(dirpath, f)
                yield os.path.relpath(path, PORT), path


def test_port_imports_without_jax_or_hello_tpu():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['hello_tpu'] = None; "
            "import hello_tpu_torch.pipeline.call, hello_tpu_torch.nn.convert, "
            "hello_tpu_torch.ops.read_conv, hello_tpu_torch.telemetry")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_or_hello_tpu_references():
    """No file imports jax or hello_tpu; files the port wrote also never
    name a hello_tpu module path (copied files keep hello_tpu's docstrings
    and are held by byte identity instead)."""
    bad = []
    for rel, path in _port_files():
        with open(path) as fh:
            text = fh.read()
        if _IMPORT.search(text):
            bad.append(f"{rel}: imports jax or hello_tpu")
        if rel not in COPIED and _NAME.search(text.replace("hello_tpu_torch", "")):
            bad.append(f"{rel}: names a hello_tpu module path")
    assert not bad, bad


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_byte_identical(rel):
    with open(os.path.join(ROOT, "hello_tpu", rel), "rb") as fh:
        want = fh.read()
    with open(os.path.join(PORT, rel), "rb") as fh:
        assert fh.read() == want


def test_scorer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from hello_tpu_torch.nn.moe import create_model
    from hello_tpu_torch.pipeline.call import Scorer, load_scorer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scorer(create_model("illumina"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_scorer("illumina")
    scorer = Scorer(create_model("illumina"), device="cpu")
    assert scorer.device.type == "cpu"
    assert not scorer.packed_conv and not scorer.compact


@pytest.mark.parametrize("flags", [
    ["--precision", "bf16"], ["--precision", "default"],
    ["--num_workers", "2"], ["--provide_features"],
])
def test_cli_rejects_unported_options(tmp_path, capsys, flags):
    from hello_tpu_torch.pipeline.call import main

    bam = tmp_path / "x.bam"
    bam.write_bytes(b"")
    with pytest.raises(SystemExit):
        main(["--bam", str(bam), "--ref", str(bam), "--out",
              str(tmp_path / "x.vcf"), "--device", "cpu"] + flags)
    assert "ROADMAP" in capsys.readouterr().err


def test_unported_precision_and_layers_raise():
    from hello_tpu_torch.nn import layers

    with pytest.raises(ValueError, match="ROADMAP"):
        layers.set_precision("bf16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layers.build_network([{"type": "BatchNorm1d",
                               "kwargs": {"num_features": 4}}])
