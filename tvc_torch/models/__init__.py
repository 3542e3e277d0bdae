from tvc_torch.models.clip import CLIPConfig, CLIPModel

__all__ = ["CLIPConfig", "CLIPModel"]
