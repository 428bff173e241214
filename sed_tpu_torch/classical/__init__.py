"""Classical baseline (counterpart of ``sed_tpu.classical``): the SVM
detector over log-mel columns, its solver on the device (``svc``)."""
