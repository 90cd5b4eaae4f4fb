"""Corpus, tokenizer and hashing embedder."""
