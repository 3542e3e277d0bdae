from tvc_torch.bank.index import EmbeddingBank, topk_exact
from tvc_torch.bank.store import ReferenceBank, ReferenceBankConfig, ReferenceItem

__all__ = ["EmbeddingBank", "ReferenceBank", "ReferenceBankConfig", "ReferenceItem", "topk_exact"]
