"""Mapper, POA aligner and the streaming pipeline."""
