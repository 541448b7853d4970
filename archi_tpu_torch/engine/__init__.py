"""Retrieval engine: flat index, BM25, top-k dispatch and the vector store."""
