from tvc_torch.bank.index import EmbeddingBank, topk_exact

__all__ = ["EmbeddingBank", "topk_exact"]
