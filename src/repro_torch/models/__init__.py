"""The transformer family's models — the twin of ``repro.models``: the
dense family and the moe family (llama4-maverick, deepseek-v2 with MLA)
so far (see ``models.transformer``)."""
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_params)

__all__ = ["decode_step", "forward", "init_cache", "init_params"]
