"""The benchmark harness of the PyTorch/CUDA port: ``cell`` runs one cell,
``registry`` finds its pieces by name, ``data`` makes the ratings,
``roofline`` and ``trace`` turn shapes and traces into metrics."""
