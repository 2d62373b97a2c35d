"""Batched LM serving (prefill + greedy decode) at the small form of an
architecture.  The twin of the JAX package's ``examples/serve_lm.py``: it
passes its arguments to ``repro_torch.launch.serve`` with ``--smoke``.

    # on the card:
    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        --arch mamba2-2.7b --batch 4 --prompt-len 32 --gen 16
    # on the host:
    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        --arch mamba2-2.7b --device cpu
"""
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    if "--smoke" not in args:
        args.append("--smoke")
    return serve_main(args)


if __name__ == "__main__":
    main()
