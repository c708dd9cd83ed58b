"""The model zoo — the twin of ``repro.models``: the dense, moe, ssm,
hybrid, audio and vlm families (see ``models.transformer``)."""
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_params)

__all__ = ["decode_step", "forward", "init_cache", "init_params"]
