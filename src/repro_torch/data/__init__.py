"""Data substrate of the port: the arrival generators and the pinned
model traces (counterpart of the reference's ``repro.data``)."""
