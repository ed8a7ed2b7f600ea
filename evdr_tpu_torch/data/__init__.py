from evdr_tpu_torch.data.align import align_by_docid
from evdr_tpu_torch.data.npz_io import (
    load_init_payload,
    load_npz,
    load_packed_npz,
    load_payload,
    load_query_payload,
    save_compressed_npz,
    tokens_to_object,
)
from evdr_tpu_torch.data.packing import (
    l2_normalize,
    pad_axis_to_multiple,
    pad_mask_object,
    pad_tokens_object,
    preprocess_docs,
    preprocess_queries,
)
from evdr_tpu_torch.data.registry import DATASETMAP, register_dataset
from evdr_tpu_torch.data.synthetic import (
    make_queries_for_corpus,
    make_synthetic_corpus,
    pooled_init_index,
    save_init_npz,
    save_synthetic_npz,
    write_dataset_fixture,
)
