# Copied from gatekeeper_tpu/flatten/__init__.py; only imports and the edits noted in this header differ.
"""Object flattening: K8s unstructured JSON → fixed-shape token tensors.

The TPU-side analog of the reference target handler's data model
(pkg/target/target.go ProcessData/HandleReview): host-side encoding of
ragged JSON into dense integer/float columns that the JAX kernels consume.
All string work (interning, regex, prefix tests, k8s quantity parsing)
happens once per distinct string at intern time and is amortized across the
resource batch — the device only ever sees int32/float32 tensors.
"""

from .vocab import Vocab, parse_quantity  # noqa: F401
from .encoder import (  # noqa: F401
    TokenTable,
    ReviewFeatures,
    FeatureBatch,
    encode_review_features,
    batch_review_features,
    flatten_leaves,
    encode_token_table,
)
