"""SPION core: block-sparse attention, its executor and the paged KV pool."""
