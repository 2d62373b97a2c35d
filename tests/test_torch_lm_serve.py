"""``python -m repro_torch.launch.serve --arch <name>`` on the host, for
each of the ten architectures at their small form: the printed line of
the JAX package's serve, the generated tokens' shape and range, the
prompts drawn as the reference draws them, the same tokens for the same
seed; and the example twin ``repro_torch.examples.serve_lm``."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.examples import serve_lm
from repro_torch.launch import serve

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LINE = re.compile(r"^arch=(\S+) prefill=\d+ms decode=\d+ms "
                  r"\(\d+\.\d tok/s\)$")
FLAGS = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--gen", "4"]


def _served(capsys, arch, *extra):
    res = serve.main(["--arch", arch, *FLAGS, *extra])
    return res, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_arch_on_cpu(capsys, arch):
    res, lines = _served(capsys, arch)
    cfg = get_config(arch, smoke=True)
    m = LINE.match(lines[0])
    assert m and m.group(1) == cfg.name, lines
    assert lines[1].startswith("sample tokens: [")
    assert res.tokens.shape == (2, 4)
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab
    assert res.logits.dtype == torch.float32
    assert bool(torch.isfinite(res.logits).all())
    want = np.random.default_rng(0).integers(1, cfg.vocab, (2, 8))
    np.testing.assert_array_equal(res.prompts.numpy(), want)
    assert res.prefill_s > 0 and res.decode_s > 0


@pytest.mark.parametrize("arch", ["qwen3-14b", "whisper-small"])
def test_serve_arch_is_deterministic_per_seed(capsys, arch):
    a, _ = _served(capsys, arch)
    b, _ = _served(capsys, arch)
    c, _ = _served(capsys, arch, "--seed", "1")
    assert torch.equal(a.tokens, b.tokens)
    assert not torch.equal(a.prompts, c.prompts)


def test_serve_lm_example_twin(capsys):
    """``repro_torch.examples.serve_lm`` adds ``--smoke``, as the JAX
    package's example does, in process and as ``python -m``."""
    res = serve_lm.main(["--arch", "mamba2-2.7b", "--device", "cpu",
                         "--batch", "2", "--gen", "3"])
    assert LINE.match(capsys.readouterr().out.splitlines()[0])
    assert res.cfg == get_config("mamba2-2.7b", smoke=True)
    assert res.tokens.shape == (2, 3)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_lm", "--arch",
         "hymba-1.5b", "--device", "cpu", "--batch", "1", "--gen", "2"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    assert LINE.match(out.stdout.splitlines()[0]).group(1) == "hymba-1.5b"


def test_decode_start_counts_the_vision_stub():
    """``serve``'s first decode position: past the prompt and the meta
    tokens, and past the vision stub's image tokens though no image is
    passed, as in the reference; whisper's is 1."""
    phi = get_config("phi-3-vision-4.2b", smoke=True)
    assert serve.decode_start(phi, 8) == 8 + phi.n_frontend_tokens
    hymba = get_config("hymba-1.5b", smoke=True)
    assert serve.decode_start(hymba, 8) == 8 + hymba.n_meta_tokens
    assert serve.decode_start(get_config("qwen3-14b", smoke=True), 8) == 8
    assert serve.decode_start(get_config("whisper-small"), 8) == 1


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-small"])
def test_serve_arch_is_generate(capsys, arch):
    """``serve --arch`` serves what ``generate`` gives for its weights and
    prompts, decoding from ``decode_start`` by default: an explicit start
    there gives the same steps, another start other logits."""
    res, _ = _served(capsys, arch)
    frames = None
    if res.cfg.encdec:
        rng = np.random.default_rng(0)
        rng.integers(1, res.cfg.vocab, (2, 8))
        frames = torch.tensor(rng.standard_normal((2, 64, res.cfg.d_model)),
                              dtype=torch.float32)
    out = serve.generate(res.cfg, res.params, res.prompts, 4, frames)
    assert torch.equal(out.tokens, res.tokens)
    assert len(out.steps) == 4 and torch.equal(out.steps[-1], res.logits)
    start = serve.decode_start(res.cfg, 8)
    same = serve.generate(res.cfg, res.params, res.prompts, 4, frames, start)
    assert torch.equal(same.steps[-1], out.steps[-1])
    other = serve.generate(res.cfg, res.params, res.prompts, 4, frames,
                           start + 1)
    assert not torch.equal(other.steps[1], out.steps[1])
