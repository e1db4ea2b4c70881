"""Persistence shared by the index lifecycle: the checkpoint format."""
