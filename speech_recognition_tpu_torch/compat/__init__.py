"""Reference TF2 checkpoints in and out of the port without TensorFlow (the port's
counterpart of speech_recognition_tpu/compat/): the numpy codec of TensorFlow's
tensor bundles (:mod:`.tensor_bundle`) and the reference's name mapping, the
loaders and the command line (:mod:`.tf_checkpoint`)."""
