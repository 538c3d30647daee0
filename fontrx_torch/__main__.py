"""``python -m fontrx_torch``: the command line (``fontrx_torch.cli.main``).

    python -m fontrx_torch -f fontrx_torch/data/DejaVuSans.ttf -t A -o a.qoi

renders 'A' at 256 px on the first CUDA device and writes it as QOI;
``--backend cpu`` runs the same on the CPU.
"""

import sys

from fontrx_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
