"""Model families (LG-SPAIR so far)."""
