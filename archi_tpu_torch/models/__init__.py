"""Text encoder, weight loading, tokenizer and the embedder."""
