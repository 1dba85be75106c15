"""Sex classification of a study from its ED and ES frames (port of examples/inference/classification_sex.py).

Prints the class probabilities; ``main`` returns them (see ``edes.py``).

Usage:
    python -m cinema_tpu_torch.examples.inference.classification_sex --model convvit.safetensors --config config.yaml \
        --ed patient_sax_ed.nii.gz --es patient_sax_es.nii.gz [--device cuda]
"""

from __future__ import annotations

from typing import List, Optional

from cinema_tpu_torch.examples.inference.edes import edes_main


def main(argv: Optional[List[str]] = None):
    return edes_main("classification", __doc__, argv)


if __name__ == "__main__":
    main()
