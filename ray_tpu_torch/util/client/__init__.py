from ray_tpu_torch.util.client.server import ClientProxyServer, start_client_server

__all__ = ["ClientProxyServer", "start_client_server"]
