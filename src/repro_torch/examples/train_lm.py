"""LM pretraining through the launcher (any --arch) at the small form of
an architecture.  The twin of the JAX package's ``examples/train_lm.py``:
it passes its arguments to ``repro_torch.launch.train`` with ``--smoke``.
Checkpointing/resume and the straggler watchdog are exercised here.

    # on the card:
    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        --arch qwen3-14b --steps 200 --batch 8 --seq 128
    # on the host:
    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        --arch qwen3-14b --steps 20 --batch 2 --seq 16 --device cpu
"""
import sys

from repro_torch.launch.train import main as train_main


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    if "--smoke" not in args:
        args.append("--smoke")
    return train_main(args)


if __name__ == "__main__":
    main()
