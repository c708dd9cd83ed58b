"""The model zoo — the twin of ``repro.models``: the dense, moe, ssm,
hybrid and audio families (see ``models.transformer``; vlm is ROADMAP.md
Queue 1 item 15)."""
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_params)

__all__ = ["decode_step", "forward", "init_cache", "init_params"]
