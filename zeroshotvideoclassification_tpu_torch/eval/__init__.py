"""Zero-shot evaluation layer: cosine-NN classification on the device and
the seeded half-class split protocol."""

from zeroshotvideoclassification_tpu_torch.eval.zeroshot import (
    compute_accuracy,
    evaluate_dataset,
    extract_embeddings,
    split_protocol,
)
