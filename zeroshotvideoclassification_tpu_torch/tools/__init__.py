"""Offline tools of the port, copies of the JAX package's tools/ with their
imports re-pointed at the port: prepare_word2vec, caption_vocab,
extract_activitynet_clips, port_checkpoint, extract_captions. They do no
device work."""
