"""Drivers of the traffic kinds, one module a kind (``traffic/*.json`` ``kind``)."""
