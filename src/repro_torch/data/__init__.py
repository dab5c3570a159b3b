"""Data substrate of the port: synthetic token batches, the arrival
generators, and the model trace zoo (capture and the pinned traces);
counterpart of the reference's ``repro.data``."""
