"""Device-side index (counterpart of Index.device())."""
