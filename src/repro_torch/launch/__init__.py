"""Launch layer: the serve driver and the Chrome-trace export of a lifecycle
trace (train, dry-run and roofline come later).

Counterpart of ``repro.launch``.
"""
