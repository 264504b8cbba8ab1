"""The examples of ``lb2d_tpu_torch``, the PyTorch / CUDA port: the eight
scripts of ``examples/`` written for the port, each runnable on its own
(``python examples_torch/<name>.py``) and importable (each has ``main``,
which returns the numbers it prints). They run on a CUDA card by default
(``device="cuda"``); ``device="cpu"`` runs the eager path.
"""
