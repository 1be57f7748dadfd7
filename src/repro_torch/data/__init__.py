from repro_torch.data.pipeline import (lm_batches, cnn_batches, make_batch,  # noqa: F401
                                       synthetic_lm_batch, synthetic_cnn_batch)
