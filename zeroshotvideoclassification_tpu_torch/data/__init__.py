"""Data layer: paths -> host batch -> device batch. The host half
(HostPipeline, VideoTable, decoders, transform parameters) is imported from
zeroshotvideoclassification_tpu.data, which imports no JAX."""
