"""Device ops: color/resize ingest, median filter, DFD, crops, boxes."""
