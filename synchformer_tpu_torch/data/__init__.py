from synchformer_tpu_torch.data.transforms import (  # noqa: F401
    make_class_grid,
    quantize_offset,
    SyncPipelineConfig,
    prepare_item,
)
