from repro_torch.data.pipeline import (MemmapSource, Pipeline, PipelineConfig,
                                       SyntheticSource, shard_batch)
