"""Serving runtime: prefill + compression, slot-layout decode."""
