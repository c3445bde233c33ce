"""LPIPS perceptual metric with a VGG16 trunk (counterpart of
ibgs_tpu/eval/lpips.py).

No weights ship with the repository, and none can be downloaded, so the
backbone and linear-head weights come from a local .npz (the JAX
package's layout, written by `scripts/export_lpips_weights.py`):

  conv{i}_w, conv{i}_b  for i in 0..12   VGG16 conv layers (OIHW)
  lin{j}_w              for j in 0..4    LPIPS 1x1 heads (1, C, 1, 1)

The function is the JAX package's: the raw [0, 1] input z-scored (no
x2-1 rescale), features tapped after relu1_2, relu2_2, relu3_3, relu4_3
and relu5_3, channel-normalised with the epsilon outside the square root,
squared differences through the 1x1 heads, spatial means summed.  The
convolutions run in float32 with TF32 off at the call (PyTorch lets
cuDNN use TF32 by default; the JAX package asks for HIGHEST precision for
the same reason).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 feature config: conv channels with 'M' max-pools
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
        512, 512, 512, "M", 512, 512, 512]
_TAPS = (3, 8, 15, 22, 29)           # torchvision feature indices
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS:
    def __init__(self, convs, lins, device="cuda"):
        self.device = torch.device(device)
        self.convs = [(w.to(self.device), b.to(self.device))
                      for w, b in convs]
        self.lins = [lin.to(self.device) for lin in lins]

    @classmethod
    def from_npz(cls, path, device="cuda"):
        d = np.load(path)
        convs, lins = [], []
        while f"conv{len(convs)}_w" in d:
            i = len(convs)
            convs.append((torch.as_tensor(d[f"conv{i}_w"]),
                          torch.as_tensor(d[f"conv{i}_b"])))
        while f"lin{len(lins)}_w" in d:
            lins.append(torch.as_tensor(d[f"lin{len(lins)}_w"]))
        return cls(convs, lins, device)

    def _features(self, x: torch.Tensor):
        """(H, W, 3) in [0, 1] → the 5 normalised feature maps."""
        shift = torch.tensor(_SHIFT, device=self.device)
        scale = torch.tensor(_SCALE, device=self.device)
        x = ((x - shift) / scale).permute(2, 0, 1)[None]      # NCHW
        feats = []
        ci = layer = 0
        for c in _CFG:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
                layer += 1
            else:
                w, b = self.convs[ci]
                x = torch.relu(F.conv2d(x, w, b, padding=1))
                ci += 1
                layer += 2
            # a tap falls on the relu just applied, index layer - 1
            if layer - 1 in _TAPS:
                feats.append(x / (torch.sqrt((x * x).sum(1, keepdim=True))
                                  + 1e-10))
        return feats

    @torch.no_grad()
    def __call__(self, a, b) -> torch.Tensor:
        """LPIPS distance of two (H, W, 3) images in [0, 1] (0-dim)."""
        def t(x):
            if torch.is_tensor(x):
                return x.to(device=self.device, dtype=torch.float32)
            return torch.as_tensor(np.array(x, np.float32)).to(self.device)

        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            fa, fb = self._features(t(a)), self._features(t(b))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        total = torch.zeros((), device=self.device)
        for f1, f2, lin in zip(fa, fb, self.lins):
            d = (f1 - f2) ** 2
            total = total + (d * lin.reshape(1, -1, 1, 1)).sum(1).mean()
        return total
