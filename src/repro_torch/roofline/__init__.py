"""The roofline of the dry-run's records — the twin of
``repro.roofline`` (``analysis``; ``report`` builds its table)."""
from repro_torch.roofline.analysis import (HW, SOURCE, RooflineTerms,
                                           model_flops, roofline_terms)

__all__ = ["HW", "SOURCE", "RooflineTerms", "model_flops", "roofline_terms"]
