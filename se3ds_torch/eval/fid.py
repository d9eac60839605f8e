"""FID / Inception-Score math (a copy of `se3ds_tpu.eval.fid`).

Host-side numpy/scipy, identical formulas: Frechet distance with the
singular-product fallback, and the split-KL inception score.
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy import linalg


class ShapeNotMatchError(Exception):
  pass


def _sqrtm(x):
  """scipy.linalg.sqrtm across scipy versions (disp deprecated)."""
  out = linalg.sqrtm(x)
  if isinstance(out, tuple):
    out = out[0]
  return out


class ImaginaryComponentError(Exception):
  pass


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
  """d^2 = ||mu1-mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))."""
  mu1 = np.atleast_1d(mu1)
  mu2 = np.atleast_1d(mu2)
  sigma1 = np.atleast_2d(sigma1)
  sigma2 = np.atleast_2d(sigma2)
  if mu1.shape != mu2.shape:
    raise ShapeNotMatchError('Training and test mean vectors have '
                             'different lengths')
  if sigma1.shape != sigma2.shape:
    raise ShapeNotMatchError('Training and test covariances have '
                             'different dimensions')
  diff = mu1 - mu2
  covmean = _sqrtm(sigma1.dot(sigma2))
  if not np.isfinite(covmean).all():
    warnings.warn('fid calculation produces singular product; adding '
                  f'{eps} to diagonal of cov estimates')
    offset = np.eye(sigma1.shape[0]) * eps
    covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
  if np.iscomplexobj(covmean):
    if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
      m = np.max(np.abs(covmean.imag))
      raise ImaginaryComponentError(f'Imaginary component {m}')
    covmean = covmean.real
  return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
          - 2 * np.trace(covmean))


def calculate_fid(pool1: np.ndarray, pool2: np.ndarray) -> float:
  mu1 = np.mean(pool1, axis=0)
  mu2 = np.mean(pool2, axis=0)
  sigma1 = np.cov(pool1, rowvar=False)
  sigma2 = np.cov(pool2, rowvar=False)
  return calculate_frechet_distance(mu1, sigma1, mu2, sigma2)


def calculate_inception_score(pred: np.ndarray, num_splits: int = 10):
  scores = []
  for index in range(num_splits):
    chunk = pred[index * (pred.shape[0] // num_splits):
                 (index + 1) * (pred.shape[0] // num_splits), :]
    kl = chunk * (np.log(chunk)
                  - np.log(np.expand_dims(np.mean(chunk, 0), 0)))
    kl = np.mean(np.sum(kl, 1))
    scores.append(np.exp(kl))
  return np.mean(scores), np.std(scores)
