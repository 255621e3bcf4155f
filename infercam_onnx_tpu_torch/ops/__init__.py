"""Device ops of the detect path: preprocess, filter + NMS, and the hand
NMS kernel's wrapper."""
