"""Launch layer: the serve driver (train, dry-run and roofline come later).

Counterpart of ``repro.launch``.
"""
