from evdr_tpu_torch.data.npz_io import (
    load_npz,
    load_packed_npz,
    load_payload,
    load_query_payload,
)
from evdr_tpu_torch.data.packing import (
    l2_normalize,
    pad_axis_to_multiple,
    pad_mask_object,
    pad_tokens_object,
    preprocess_docs,
    preprocess_queries,
)
