"""GAN losses and the CounteRGAN generator objective (mirrors
`cfgan/losses`)."""
from cfgan_torch.losses.gan import (
    bce_logits,
    d_loss_bce,
    d_loss_nonsaturating,
    d_loss_wasserstein,
    g_loss_bce,
    g_loss_nonsaturating,
    g_loss_wasserstein,
    gradient_penalty,
)
from cfgan_torch.losses.countergan import countergan_g_terms, CounterGANTerms

__all__ = [
    "bce_logits",
    "d_loss_bce",
    "d_loss_nonsaturating",
    "d_loss_wasserstein",
    "g_loss_bce",
    "g_loss_nonsaturating",
    "g_loss_wasserstein",
    "gradient_penalty",
    "countergan_g_terms",
    "CounterGANTerms",
]
