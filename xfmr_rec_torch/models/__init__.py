"""Text encoder, tokenizers and weight conversion."""
