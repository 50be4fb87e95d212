"""Drop-in namespace for the reference package layout, over the PyTorch
port.

Every module path of the ``obia`` namespace resolves here to the same
objects of :mod:`obia_tpu_torch`, so reference users can run on the card
without changing their imports beyond the top-level name:

    from obia_torch.segmentation.segment import segment
    from obia_torch.classification.classify import classify
"""
__version__ = "0.1.0"
