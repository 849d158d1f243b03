from repro_torch.models.transformer import (forward, init_cache,  # noqa: F401
                                            init_params, lm_loss)
