"""Paged KV backend: block pools, block tables and the int8/fp8 codec."""
