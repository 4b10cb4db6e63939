"""Data-plane helpers of the port (the tokenizer)."""
